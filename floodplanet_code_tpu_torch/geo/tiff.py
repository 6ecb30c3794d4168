"""GeoTIFF I/O for the data layer.

The PyTorch port's own copy of ``floodplanet_code_tpu/geo/tiff.py``: the
library builds from this package's ``native/tiffio.cpp`` into this
package's ``native/`` directory, never into the JAX package's tree.

Reading goes through the native C++ reader (``native/tiffio.cpp``, built with
``g++`` on first use, see ``load_library``) for strip/tile-aware *windowed* decode — replacing the
reference's tifffile/rasterio whole-scene reads (floodplanet.py:309-318,
605-609). Writing (mask/prediction export, a cold path) is pure Python,
producing uncompressed striped GeoTIFFs and carrying the geo-referencing
tags over from a source scene so exported masks stay georeferenced
(reference export paths: infer.py:179-184, utils_image.py:522-564).

API:
    info(path) -> TiffInfo
    imread(path) -> np.ndarray           # [C,H,W] (C>1) or [H,W]
    read_window(path, y0, x0, h, w)      # windowed read, same layout
    imwrite(path, array, geo_from=None)  # [H,W] / [C,H,W] / [H,W,C]
    TiffFile(path)                       # handle reuse for many windows
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import sys
import threading
from dataclasses import dataclass

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
_SRC = os.path.join(_NATIVE_DIR, "tiffio.cpp")
_LIB = os.path.join(_NATIVE_DIR, "libtiffio.so")

_lib_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _build_library() -> None:
    # Build to a private name and rename: processes that build at the same
    # time (parallel test workers) never load a half-written library.
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [
        "g++",
        "-O3",
        "-shared",
        "-fPIC",
        "-std=c++17",
        _SRC,
        "-o",
        tmp,
        "-lz",
    ]
    result = subprocess.run(cmd, capture_output=True, text=True)
    if result.returncode != 0:
        raise RuntimeError(
            f"Failed to build native tiffio library:\n{result.stderr}"
        )
    os.replace(tmp, _LIB)


def _load_library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        needs_build = not os.path.exists(_LIB) or (
            os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
        )
        if needs_build:
            _build_library()
        lib = ctypes.CDLL(_LIB)
        lib.tiffio_open.restype = ctypes.c_void_p
        lib.tiffio_open.argtypes = [ctypes.c_char_p]
        lib.tiffio_close.argtypes = [ctypes.c_void_p]
        lib.tiffio_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        lib.tiffio_read_window.restype = ctypes.c_int
        lib.tiffio_read_window.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_void_p,
        ]
        lib.tiffio_error.restype = ctypes.c_char_p
        lib.tiffio_geo_tags.restype = ctypes.c_int64
        lib.tiffio_geo_tags.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
        ]
        lib.tiffio_read_windows_batch.restype = ctypes.c_int64
        lib.tiffio_read_windows_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int64,
        ]
        _lib = lib
        return lib


def load_library() -> ctypes.CDLL:
    """Build the native reader if it is missing or stale, and load it."""
    return _load_library()


@dataclass(frozen=True)
class TiffInfo:
    width: int
    height: int
    samples: int
    bits: int
    sample_format: int  # 1 uint, 2 int, 3 float
    planar: int
    compression: int
    tile_width: int
    tile_height: int
    rows_per_strip: int

    @property
    def dtype(self) -> np.dtype:
        kind = {1: "u", 2: "i", 3: "f"}.get(self.sample_format, "u")
        return np.dtype(f"{kind}{self.bits // 8}")

    @property
    def shape(self):
        if self.samples == 1:
            return (self.height, self.width)
        return (self.samples, self.height, self.width)


class TiffFile:
    """An open TIFF handle supporting repeated windowed reads."""

    def __init__(self, path: str):
        self._lib = _load_library()
        self.path = path
        self._handle = self._lib.tiffio_open(path.encode())
        if not self._handle:
            raise IOError(
                f"tiffio: {self._lib.tiffio_error().decode()} ({path})"
            )
        raw = (ctypes.c_int64 * 10)()
        self._lib.tiffio_info(self._handle, raw)
        self.info = TiffInfo(*[int(v) for v in raw])

    def read_window(self, y0: int, x0: int, height: int, width: int) -> np.ndarray:
        """Read a [C,h,w] (or [h,w] if single-band) window in native dtype."""
        info = self.info
        out = np.empty((info.samples, height, width), dtype=info.dtype)
        rc = self._lib.tiffio_read_window(
            self._handle,
            y0,
            x0,
            height,
            width,
            out.ctypes.data_as(ctypes.c_void_p),
        )
        if rc != 0:
            raise IOError(
                f"tiffio read_window failed: {self._lib.tiffio_error().decode()} "
                f"({self.path} y0={y0} x0={x0} h={height} w={width})"
            )
        if info.samples == 1:
            return out[0]
        return out

    def read(self) -> np.ndarray:
        return self.read_window(0, 0, self.info.height, self.info.width)

    def geo_tags(self) -> list[tuple[int, int, int, bytes]]:
        """Geo-referencing tags as (tag, type, count, little-endian bytes)."""
        need = self._lib.tiffio_geo_tags(self._handle, None, 0)
        if need <= 0:
            return []
        buf = (ctypes.c_uint8 * need)()
        self._lib.tiffio_geo_tags(self._handle, buf, need)
        data = bytes(buf)
        tags = []
        pos = 0
        while pos + 8 <= len(data):
            tag, typ, count = struct.unpack_from("<HHI", data, pos)
            size = _TYPE_SIZES[typ] * count
            tags.append((tag, typ, count, data[pos + 8 : pos + 8 + size]))
            pos += 8 + size
        return tags

    def close(self) -> None:
        if self._handle:
            self._lib.tiffio_close(self._handle)
            self._handle = None

    def __enter__(self) -> "TiffFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        if sys is None or sys.is_finalizing():
            # Interpreter shutdown: the ctypes library may already be
            # unloaded; calling into it can crash at exit. Leak the handle
            # (the OS reclaims the fd).
            return
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Graceful per-file fallback. The reference tolerates reader quirks by
# carrying two backends (tifffile OR rasterio, floodplanet.py:309-318); the
# native reader here gets the same safety net: when it cannot parse a file
# (exotic compression, corrupt IFD), the read retries through whichever
# pure-Python backend exists (tifffile if installed, else PIL, else OpenCV)
# and logs once per file instead of hard-failing the run.
# ---------------------------------------------------------------------------

_fallback_warned: set[str] = set()


def _warn_fallback(path: str, reason: str, backend: str) -> None:
    if path not in _fallback_warned:
        _fallback_warned.add(path)
        print(
            f"[geo.tiff] native reader failed for {path} ({reason}); "
            f"falling back to {backend}",
            file=sys.stderr,
        )


def _fallback_imread(path: str) -> tuple[np.ndarray, str]:
    """Read a full image via the first working pure-Python backend.

    Returns (array, backend_name); the array is [C,H,W] or [H,W] to match
    the native reader's layout contract.
    """
    errors = []
    try:
        import tifffile  # not in the base image; honored if installed

        arr = np.asarray(tifffile.imread(path))
        # tifffile yields (H,W), (H,W,C) for contig or (C,H,W) for planar
        # pages; use the series axes to normalize instead of guessing.
        with tifffile.TiffFile(path) as handle:
            axes = handle.series[0].axes
        if arr.ndim == 3 and axes.upper().endswith("S"):
            arr = np.transpose(arr, (2, 0, 1))
        return arr, "tifffile"
    except ImportError:
        pass
    except Exception as exc:  # noqa: BLE001 — try the next backend
        errors.append(f"tifffile: {exc}")
    try:
        from PIL import Image

        with Image.open(path) as img:
            arr = np.asarray(img)
        if arr.ndim == 3:
            arr = np.transpose(arr, (2, 0, 1))
        return arr, "PIL"
    except Exception as exc:  # noqa: BLE001
        errors.append(f"PIL: {exc}")
    try:
        import cv2

        arr = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if arr is None:
            raise IOError("cv2.imread returned None")
        if arr.ndim == 3:
            # OpenCV loads interleaved BGR / BGRA; restore file band order
            # (alpha stays last for 4-band).
            if arr.shape[2] == 3:
                arr = arr[:, :, ::-1]
            elif arr.shape[2] == 4:
                arr = arr[:, :, [2, 1, 0, 3]]
            arr = np.transpose(arr, (2, 0, 1))
        return arr, "cv2"
    except Exception as exc:  # noqa: BLE001
        errors.append(f"cv2: {exc}")
    raise IOError(
        f"all fallback TIFF backends failed for {path}: " + "; ".join(errors)
    )


class _FallbackTiff:
    """Pure-Python stand-in for TiffFile when the native reader fails.

    Decodes the whole file once through _fallback_imread and serves windows
    by slicing — slower and memory-heavier than the native windowed reads,
    which is acceptable for the rare unparseable file.
    """

    def __init__(self, path: str, reason: str):
        self.path = path
        arr, backend = _fallback_imread(path)
        _warn_fallback(path, reason, backend)
        if arr.ndim == 3 and arr.shape[0] == 1:
            arr = arr[0]  # native contract: single-band reads are [H,W]
        self._arr = arr
        samples = 1 if arr.ndim == 2 else arr.shape[0]
        height, width = arr.shape[-2:]
        fmt = {"u": 1, "i": 2, "f": 3}.get(arr.dtype.kind, 1)
        self.info = TiffInfo(
            width=width,
            height=height,
            samples=samples,
            bits=arr.dtype.itemsize * 8,
            sample_format=fmt,
            planar=1,
            compression=1,
            tile_width=0,
            tile_height=0,
            rows_per_strip=height,
        )

    def read_window(self, y0: int, x0: int, height: int, width: int) -> np.ndarray:
        info = self.info
        if (
            y0 < 0
            or x0 < 0
            or y0 + height > info.height
            or x0 + width > info.width
        ):
            raise IOError(
                f"window out of bounds ({self.path} y0={y0} x0={x0} "
                f"h={height} w={width} vs {info.height}x{info.width})"
            )
        return self._arr[..., y0 : y0 + height, x0 : x0 + width].copy()

    def read(self) -> np.ndarray:
        return self._arr

    def geo_tags(self) -> list[tuple[int, int, int, bytes]]:
        # Fallback decoding loses the raw tag bytes; callers treat a missing
        # geo block as "no georeferencing to carry over".
        return []

    def close(self) -> None:
        self._arr = None


# Small process-wide handle cache so per-tile windowed reads do not reopen
# and re-parse the IFD every time (the dataset layer reads many windows from
# the same scene).
_CACHE_SIZE = 64
_handle_cache: dict[str, "TiffFile | _FallbackTiff"] = {}
_cache_lock = threading.Lock()


def _cached_file(path: str) -> "TiffFile | _FallbackTiff":
    path = os.path.abspath(path)
    with _cache_lock:
        handle = _handle_cache.get(path)
        if handle is None:
            try:
                handle = TiffFile(path)
            except IOError as exc:
                handle = _FallbackTiff(path, str(exc))  # raises if hopeless
            _handle_cache[path] = handle
            while len(_handle_cache) > _CACHE_SIZE:
                oldest_key = next(iter(_handle_cache))
                # Evict without closing: another thread may be mid-read on
                # the handle; __del__ closes it once all references drop.
                _handle_cache.pop(oldest_key)
        return handle


def _demote_to_fallback(path: str, reason: str) -> _FallbackTiff:
    """Replace a cached native handle that failed mid-read with a fallback."""
    path = os.path.abspath(path)
    handle = _FallbackTiff(path, reason)  # raises if no backend can read it
    with _cache_lock:
        stale = _handle_cache.pop(path, None)
        _handle_cache[path] = handle
    if isinstance(stale, TiffFile):
        stale.close()
    return handle


def info(path: str) -> TiffInfo:
    return _cached_file(path).info


def imread(path: str) -> np.ndarray:
    handle = _cached_file(path)
    try:
        return handle.read()
    except IOError as exc:
        if isinstance(handle, _FallbackTiff):
            raise
        return _demote_to_fallback(path, str(exc)).read()


def read_window(path: str, y0: int, x0: int, height: int, width: int) -> np.ndarray:
    handle = _cached_file(path)
    try:
        return handle.read_window(y0, x0, height, width)
    except IOError as exc:
        if isinstance(handle, _FallbackTiff):
            raise
        return _demote_to_fallback(path, str(exc)).read_window(
            y0, x0, height, width
        )


def read_windows_batch(
    paths: list[str],
    windows: list[tuple[int, int, int, int]],
    n_threads: int = 8,
) -> list[np.ndarray]:
    """Read many windows in one native call (C++ thread pool, single GIL
    release). Each result is CHW (or HW if single-band) in native dtype.

    The native data-loader hot path: the whole batch's tile reads run in
    parallel worker threads inside libtiffio, replacing the reference's
    per-sample python DataLoader reads (SURVEY.md §2.4, §3.4).
    """
    lib = _load_library()
    n = len(paths)
    assert len(windows) == n
    files = [_cached_file(p) for p in paths]
    results: list[np.ndarray | None] = [None] * n
    # Fallback-backed files are served by slicing; only native handles go
    # through the batched C++ read.
    native = [i for i, f in enumerate(files) if isinstance(f, TiffFile)]
    for i, f in enumerate(files):
        if not isinstance(f, TiffFile):
            y0, x0, h, w = windows[i]
            results[i] = f.read_window(y0, x0, h, w)
    outs = []
    m = len(native)
    if m:
        handles = (ctypes.c_void_p * m)()
        dsts = (ctypes.c_void_p * m)()
        win_arr = (ctypes.c_int64 * (4 * m))()
        for j, i in enumerate(native):
            f = files[i]
            y0, x0, h, w = windows[i]
            info_ = f.info
            out = np.empty((info_.samples, h, w), dtype=info_.dtype)
            outs.append(out)
            handles[j] = f._handle
            dsts[j] = out.ctypes.data_as(ctypes.c_void_p).value
            win_arr[4 * j : 4 * j + 4] = [y0, x0, h, w]
        failures = lib.tiffio_read_windows_batch(
            handles, win_arr, m, dsts, n_threads
        )
        if failures:
            # The batch API reports a count, not which windows failed:
            # retry every native window through the per-window path, which
            # demotes unreadable files to the pure-Python fallback (and
            # raises only if no backend can read them).
            for i in native:
                y0, x0, h, w = windows[i]
                results[i] = read_window(paths[i], y0, x0, h, w)
        else:
            for j, i in enumerate(native):
                o = outs[j]
                results[i] = o[0] if o.shape[0] == 1 else o
    return results  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# Writer (pure Python; classic little-endian TIFF, uncompressed strips).
# ---------------------------------------------------------------------------

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8}

_DTYPE_TO_FORMAT = {
    "u": 1,
    "i": 2,
    "f": 3,
}


def imwrite(
    path: str,
    array: np.ndarray,
    geo_from: str | None = None,
    planar_as_chw: bool = True,
    bigtiff: bool | None = None,
) -> None:
    """Write an array as an uncompressed striped TIFF.

    Accepts [H,W], [C,H,W] (default interpretation for 3-D, matching the
    pipeline's band-sequential layout) or [H,W,C] when ``planar_as_chw`` is
    False. Multi-band data is stored interleaved (PlanarConfig=1).
    When ``geo_from`` names a source GeoTIFF, its geo-referencing tags are
    copied so exported masks stay georeferenced.

    ``bigtiff=None`` (default) transparently switches to BigTIFF (version
    43, 64-bit offsets) once the pixel payload would overflow classic
    TIFF's 32-bit strip offsets — the same behavior the reference inherits
    from tifffile (utils/utils_image.py:530-533). ``True`` forces BigTIFF;
    ``False`` forces classic and raises on a too-large canvas.
    """
    array = np.asarray(array)
    if array.ndim == 2:
        hwc = array[:, :, None]
    elif array.ndim == 3:
        hwc = np.transpose(array, (1, 2, 0)) if planar_as_chw else array
    else:
        raise ValueError(f"Cannot write array with ndim={array.ndim}")
    height, width, samples = hwc.shape

    # Classic TIFF carries 32-bit strip offsets: past ~4 GB we switch to
    # BigTIFF (decided before any pixel copy).
    approx_bytes = height * width * samples * hwc.dtype.itemsize
    needs_big = approx_bytes >= 2**32 - (1 << 20)
    if bigtiff is None:
        bigtiff = needs_big
    elif not bigtiff and needs_big:
        raise ValueError(
            f"classic TIFF cannot hold {approx_bytes / 1e9:.1f} GB "
            f"({height}x{width}x{samples} {hwc.dtype}): 32-bit strip "
            "offsets overflow past 4 GB. Drop bigtiff=False, write the "
            "canvas tiled, downsample, or use a narrower dtype "
            "(uint8 masks instead of float probabilities)."
        )

    kind = hwc.dtype.kind
    if kind == "b":
        hwc = hwc.astype(np.uint8)
        kind = "u"
    if kind not in _DTYPE_TO_FORMAT:
        raise ValueError(f"Unsupported dtype for TIFF write: {hwc.dtype}")
    sample_format = _DTYPE_TO_FORMAT[kind]
    bits = hwc.dtype.itemsize * 8

    hwc = np.ascontiguousarray(hwc)
    if hwc.dtype.byteorder == ">":
        hwc = hwc.astype(hwc.dtype.newbyteorder("<"))

    # Strips of ~256 KB.
    row_bytes = width * samples * hwc.dtype.itemsize
    rows_per_strip = max(1, min(height, (256 * 1024) // max(1, row_bytes)))
    n_strips = (height + rows_per_strip - 1) // rows_per_strip
    strip_counts = []
    for s in range(n_strips):
        rows = min(rows_per_strip, height - s * rows_per_strip)
        strip_counts.append(rows * row_bytes)

    geo_tags: list[tuple[int, int, int, bytes]] = []
    if geo_from is not None and os.path.exists(geo_from):
        try:
            geo_tags = _cached_file(geo_from).geo_tags()
        except IOError:
            geo_tags = []

    # Assemble tags: (tag, type, count, packed little-endian value bytes).
    def short(v):
        return struct.pack("<H", v)

    def long_(v):
        return struct.pack("<I", v)

    tags: list[tuple[int, int, int, bytes]] = [
        (256, 4, 1, long_(width)),
        (257, 4, 1, long_(height)),
        (258, 3, samples, b"".join(short(bits) for _ in range(samples))),
        (259, 3, 1, short(1)),  # no compression
        (262, 3, 1, short(1)),  # BlackIsZero
        (277, 3, 1, short(samples)),
        (278, 4, 1, long_(rows_per_strip)),
        (284, 3, 1, short(1)),  # contiguous planes
        (339, 3, samples, b"".join(short(sample_format) for _ in range(samples))),
    ]
    tags.extend(geo_tags)

    # StripOffsets/StripByteCounts need the layout decided first. Layout:
    # header | IFD | external tag data | pixel data strips.
    # Classic: 8-byte header, u16 entry count, 12-byte entries (4-byte
    # value/offset field), u32 next-IFD. BigTIFF (version 43): 16-byte
    # header, u64 entry count, 20-byte entries (u64 count, 8-byte
    # value/offset field), u64 next-IFD, LONG8 strip arrays.
    n_entries = len(tags) + 2  # + StripOffsets + StripByteCounts
    if bigtiff:
        ifd_offset = 16
        ifd_size = 8 + n_entries * 20 + 8
        inline_max = 8
        off_fmt = "<Q"
        strip_type, strip_item = 16, 8  # LONG8
    else:
        ifd_offset = 8
        ifd_size = 2 + n_entries * 12 + 4
        inline_max = 4
        off_fmt = "<I"
        strip_type, strip_item = 4, 4  # LONG

    # External data area starts after IFD.
    external: list[bytes] = []
    ext_offset = ifd_offset + ifd_size

    def place(value_bytes: bytes) -> bytes:
        """Return the entry's inline-or-offset value field."""
        nonlocal ext_offset
        if len(value_bytes) <= inline_max:
            return value_bytes.ljust(inline_max, b"\x00")
        aligned = value_bytes + (b"\x00" if len(value_bytes) % 2 else b"")
        external.append(aligned)
        off_bytes = struct.pack(off_fmt, ext_offset)
        ext_offset += len(aligned)
        return off_bytes

    # First pass to compute external sizes for strip offsets placement: build
    # entries for all tags except strip offsets/counts, then compute where
    # pixel data lands.
    entry_blobs: list[tuple[int, int, int, bytes]] = list(tags)

    strip_off_bytes = strip_item * n_strips
    strip_cnt_bytes = strip_item * n_strips
    # Reserve external slots for strip arrays if they don't fit inline.
    data_start = ifd_offset + ifd_size
    ext_total = 0
    for _, _, _, data in entry_blobs:
        if len(data) > inline_max:
            ext_total += len(data) + (len(data) % 2)
    if strip_off_bytes > inline_max:
        ext_total += strip_off_bytes
    if strip_cnt_bytes > inline_max:
        ext_total += strip_cnt_bytes
    pixel_start = data_start + ext_total

    strip_offsets = []
    acc = pixel_start
    for count in strip_counts:
        strip_offsets.append(acc)
        acc += count

    entry_blobs.append(
        (
            273,
            strip_type,
            n_strips,
            b"".join(struct.pack(off_fmt, o) for o in strip_offsets),
        )
    )
    entry_blobs.append(
        (
            279,
            strip_type,
            n_strips,
            b"".join(struct.pack(off_fmt, c) for c in strip_counts),
        )
    )
    entry_blobs.sort(key=lambda item: item[0])

    # Emit header + IFD + external data, then stream the pixel buffer
    # (no tobytes() copy: exactly the >4 GB case must not double memory).
    out = bytearray()
    if bigtiff:
        out += b"II" + struct.pack("<HHH", 43, 8, 0)
        out += struct.pack("<Q", ifd_offset)
        out += struct.pack("<Q", n_entries)
    else:
        out += b"II" + struct.pack("<H", 42) + struct.pack("<I", ifd_offset)
        out += struct.pack("<H", n_entries)
    entry_fmt = "<HHQ" if bigtiff else "<HHI"
    ext_offset = data_start
    external = []
    for tag, typ, count, data in entry_blobs:
        out += struct.pack(entry_fmt, tag, typ, count) + place(data)
    out += struct.pack(off_fmt, 0)  # next IFD
    for blob in external:
        out += blob
    assert len(out) == pixel_start, (len(out), pixel_start)

    tmp_path = path + ".tmp"
    with open(tmp_path, "wb") as handle:
        handle.write(out)
        handle.write(memoryview(hwc).cast("B"))
    os.replace(tmp_path, path)
    # Invalidate any cached open handle for this path.
    with _cache_lock:
        stale = _handle_cache.pop(os.path.abspath(path), None)
    if stale is not None:
        stale.close()
