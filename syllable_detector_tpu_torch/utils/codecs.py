"""Compressed-audio ingest: OGG Vorbis + MP3 via ctypes, soundfile optional.

The reference CLI decodes anything AVFoundation reads — MP3/AAC/FLAC/CAF
included (reference: SyllableDetectorCLI/main.swift:63-76). This module
extends the framework's ingest surface beyond the raw-PCM containers in
utils/wav.py using ONLY libraries loadable at runtime, with graceful
degradation when absent:

  * OGG Vorbis decode via libvorbisfile (``read_ogg_vorbis``), encode via
    libvorbisenc (``write_ogg_vorbis`` — used by tests for a true
    roundtrip, and generally useful for exporting detection signals).
  * MP3 decode via libmpg123 (``read_mp3``).
  * Any-format fallback via the optional ``soundfile`` (libsndfile)
    package when installed (``read_soundfile``) — FLAC/OGG/CAF/….

All readers return ([n, channels] float32 in [-1, 1], rate) and raise
ValueError on malformed input / RuntimeError when the codec library is
unavailable, matching the utils.wav error contract (ingest callers catch
(OSError, ValueError) per file).

ctypes notes: the ogg/vorbis structs whose FIELDS we touch (ogg_page,
vorbis_info) use their stable public ABI layouts; every other struct
(OggVorbis_File, vorbis_dsp_state, vorbis_block, ogg_stream_state,
ogg_packet, vorbis_comment) is treated as opaque caller-allocated storage,
deliberately oversized — the libraries do all field access themselves.
"""

from __future__ import annotations

import ctypes
import os
from typing import Union

import numpy as np

__all__ = [
    "ogg_vorbis_available",
    "read_ogg_vorbis",
    "vorbis_encoder_available",
    "write_ogg_vorbis",
    "mp3_available",
    "read_mp3",
    "mp3_encoder_available",
    "write_mp3",
    "soundfile_available",
    "read_soundfile",
]


# ---------------------------------------------------------------------------
# library loading (injectable for tests, like runtime/alsa.py)
# ---------------------------------------------------------------------------

_libs: dict = {}
_tried: set = set()

_SONAMES = {
    "vorbisfile": "libvorbisfile.so.3",
    "vorbis": "libvorbis.so.0",
    "vorbisenc": "libvorbisenc.so.2",
    "ogg": "libogg.so.0",
    "mpg123": "libmpg123.so.0",
    "mp3lame": "libmp3lame.so.0",
}


def _load(name: str):
    if name in _libs:
        return _libs[name]
    if name in _tried:
        return None
    _tried.add(name)
    try:
        _libs[name] = ctypes.CDLL(_SONAMES[name])
    except OSError:
        _libs[name] = None
    return _libs[name]


def _reset_libs_for_test():
    _libs.clear()
    _tried.clear()


# ---------------------------------------------------------------------------
# OGG Vorbis decode (libvorbisfile)
# ---------------------------------------------------------------------------

# vorbis_info: the one vorbis struct we read fields from (codec.h, stable ABI)
class _VorbisInfo(ctypes.Structure):
    _fields_ = [
        ("version", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("rate", ctypes.c_long),
        ("bitrate_upper", ctypes.c_long),
        ("bitrate_nominal", ctypes.c_long),
        ("bitrate_lower", ctypes.c_long),
        ("bitrate_window", ctypes.c_long),
        ("codec_setup", ctypes.c_void_p),
    ]


# ogg_page: read header/body to write pages out (ogg.h, stable ABI)
class _OggPage(ctypes.Structure):
    _fields_ = [
        ("header", ctypes.POINTER(ctypes.c_ubyte)),
        ("header_len", ctypes.c_long),
        ("body", ctypes.POINTER(ctypes.c_ubyte)),
        ("body_len", ctypes.c_long),
    ]


# generously-oversized opaque storage (real sizes are ~0.2-1 KB)
_OV_FILE_SIZE = 4096
_DSP_SIZE = 1024
_BLOCK_SIZE = 1024
_STREAM_SIZE = 4096
_PACKET_SIZE = 256
_COMMENT_SIZE = 256
_INFO_SIZE = 256


def ogg_vorbis_available() -> bool:
    return _load("vorbisfile") is not None


def read_ogg_vorbis(path: Union[str, "os.PathLike"]) -> tuple[np.ndarray, int]:
    """Decode an OGG Vorbis file -> ([n, channels] float32, rate)."""
    vf_lib = _load("vorbisfile")
    if vf_lib is None:
        raise RuntimeError("libvorbisfile.so.3 is not available")

    vf_lib.ov_fopen.restype = ctypes.c_int
    vf_lib.ov_fopen.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    vf_lib.ov_info.restype = ctypes.POINTER(_VorbisInfo)
    vf_lib.ov_info.argtypes = [ctypes.c_void_p, ctypes.c_int]
    vf_lib.ov_read_float.restype = ctypes.c_long
    vf_lib.ov_read_float.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.POINTER(ctypes.c_float))),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    vf_lib.ov_clear.argtypes = [ctypes.c_void_p]

    vf = ctypes.create_string_buffer(_OV_FILE_SIZE)
    rc = vf_lib.ov_fopen(str(path).encode(), vf)
    if rc != 0:
        raise ValueError(f"{path}: not a decodable OGG Vorbis file (rc={rc})")
    try:
        info = vf_lib.ov_info(vf, -1)
        if not info:
            raise ValueError(f"{path}: ov_info failed")
        channels = int(info.contents.channels)
        rate = int(info.contents.rate)
        if channels < 1 or rate <= 0:
            raise ValueError(f"{path}: invalid Vorbis stream parameters")

        chunks = []
        pcm = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))()
        bitstream = ctypes.c_int(0)
        while True:
            got = vf_lib.ov_read_float(
                vf, ctypes.byref(pcm), 4096, ctypes.byref(bitstream)
            )
            if got == 0:
                break
            if got < 0:
                raise ValueError(f"{path}: corrupt Vorbis data (rc={got})")
            frame = np.empty((got, channels), np.float32)
            for c in range(channels):
                frame[:, c] = np.ctypeslib.as_array(pcm[c], shape=(got,))
            chunks.append(frame)
        if not chunks:
            return np.zeros((0, channels), np.float32), rate
        return np.concatenate(chunks, axis=0), rate
    finally:
        vf_lib.ov_clear(vf)


# ---------------------------------------------------------------------------
# OGG Vorbis encode (libvorbisenc) — roundtrip testing + signal export
# ---------------------------------------------------------------------------


def vorbis_encoder_available() -> bool:
    return all(
        _load(n) is not None for n in ("vorbis", "vorbisenc", "ogg")
    )


def write_ogg_vorbis(
    path: Union[str, "os.PathLike"],
    samples: np.ndarray,
    rate: int,
    quality: float = 0.6,
) -> None:
    """Encode [n] or [n, channels] float32 samples to an OGG Vorbis file."""
    if not vorbis_encoder_available():
        raise RuntimeError("libvorbis/libvorbisenc/libogg are not available")
    vorbis = _load("vorbis")
    venc = _load("vorbisenc")
    ogg = _load("ogg")

    samples = np.asarray(samples, np.float32)
    if samples.ndim == 1:
        samples = samples[:, None]
    n, channels = samples.shape

    venc.vorbis_encode_init_vbr.restype = ctypes.c_int
    venc.vorbis_encode_init_vbr.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_float,
    ]
    vorbis.vorbis_analysis_buffer.restype = ctypes.POINTER(
        ctypes.POINTER(ctypes.c_float)
    )
    vorbis.vorbis_analysis_buffer.argtypes = [ctypes.c_void_p, ctypes.c_int]

    vi = ctypes.create_string_buffer(_INFO_SIZE)
    vorbis.vorbis_info_init(vi)
    rc = venc.vorbis_encode_init_vbr(
        vi, ctypes.c_long(channels), ctypes.c_long(int(rate)),
        ctypes.c_float(quality),
    )
    if rc != 0:
        vorbis.vorbis_info_clear(vi)
        raise ValueError(f"vorbis_encode_init_vbr failed (rc={rc})")

    vc = ctypes.create_string_buffer(_COMMENT_SIZE)
    vd = ctypes.create_string_buffer(_DSP_SIZE)
    vb = ctypes.create_string_buffer(_BLOCK_SIZE)
    os_state = ctypes.create_string_buffer(_STREAM_SIZE)
    op = ctypes.create_string_buffer(_PACKET_SIZE)
    og = _OggPage()

    vorbis.vorbis_comment_init(vc)
    vorbis.vorbis_analysis_init(vd, vi)
    vorbis.vorbis_block_init(vd, vb)
    ogg.ogg_stream_init(os_state, ctypes.c_int(0x53445400))

    try:
        with open(path, "wb") as fh:

            def write_page(pg):
                fh.write(
                    ctypes.string_at(pg.header, pg.header_len)
                    + ctypes.string_at(pg.body, pg.body_len)
                )

            # the three header packets, flushed onto their own pages
            h1 = ctypes.create_string_buffer(_PACKET_SIZE)
            h2 = ctypes.create_string_buffer(_PACKET_SIZE)
            h3 = ctypes.create_string_buffer(_PACKET_SIZE)
            vorbis.vorbis_analysis_headerout(vd, vc, h1, h2, h3)
            for h in (h1, h2, h3):
                ogg.ogg_stream_packetin(os_state, h)
            while ogg.ogg_stream_flush(os_state, ctypes.byref(og)):
                write_page(og)

            def drain(eos: bool):
                while vorbis.vorbis_analysis_blockout(vd, vb) == 1:
                    vorbis.vorbis_analysis(vb, None)
                    vorbis.vorbis_bitrate_addblock(vb)
                    while vorbis.vorbis_bitrate_flushpacket(vd, op) == 1:
                        ogg.ogg_stream_packetin(os_state, op)
                        while ogg.ogg_stream_pageout(os_state, ctypes.byref(og)):
                            write_page(og)
                if eos:
                    while ogg.ogg_stream_flush(os_state, ctypes.byref(og)):
                        write_page(og)

            chunk = 1024
            for start in range(0, n, chunk):
                m = min(chunk, n - start)
                buf = vorbis.vorbis_analysis_buffer(vd, ctypes.c_int(m))
                for c in range(channels):
                    # the contiguous copy MUST stay referenced through the
                    # memmove: `.ctypes.data` yields a bare int, so a
                    # temporary array would be freed before the copy reads
                    # it (heap-state-dependent garbage audio)
                    col = np.ascontiguousarray(samples[start : start + m, c])
                    ctypes.memmove(buf[c], col.ctypes.data, m * 4)
                    del col
                vorbis.vorbis_analysis_wrote(vd, ctypes.c_int(m))
                drain(eos=False)
            vorbis.vorbis_analysis_wrote(vd, 0)  # end of stream
            drain(eos=True)
    finally:
        ogg.ogg_stream_clear(os_state)
        vorbis.vorbis_block_clear(vb)
        vorbis.vorbis_dsp_clear(vd)
        vorbis.vorbis_comment_clear(vc)
        vorbis.vorbis_info_clear(vi)


# ---------------------------------------------------------------------------
# MP3 decode (libmpg123)
# ---------------------------------------------------------------------------

_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ENC_FLOAT_32 = 0x200
_MPG123_ADD_FLAGS = 2  # enum mpg123_parms
_MPG123_FORCE_FLOAT = 0x400  # param flag: decode to float regardless


def mp3_available() -> bool:
    return _load("mpg123") is not None


def read_mp3(path: Union[str, "os.PathLike"]) -> tuple[np.ndarray, int]:
    """Decode an MP3 (MPEG layer I/II/III) file -> ([n, ch] float32, rate)."""
    lib = _load("mpg123")
    if lib is None:
        raise RuntimeError("libmpg123.so.0 is not available")

    lib.mpg123_init()
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_open.restype = ctypes.c_int
    lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mpg123_getformat.restype = ctypes.c_int
    lib.mpg123_getformat.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
    lib.mpg123_format.restype = ctypes.c_int
    lib.mpg123_format.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
    ]
    lib.mpg123_read.restype = ctypes.c_int
    lib.mpg123_read.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.mpg123_close.argtypes = [ctypes.c_void_p]
    lib.mpg123_delete.argtypes = [ctypes.c_void_p]

    lib.mpg123_param.restype = ctypes.c_int
    lib.mpg123_param.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_double,
    ]

    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed (rc={err.value})")
    try:
        # FORCE_FLOAT must be set BEFORE open: the output format locks in
        # when the stream header is parsed, and a later mpg123_format call
        # does NOT renegotiate it — without this flag real (non-silent)
        # MP3s decoded as int16 bytes misread as float32
        lib.mpg123_param(
            h, _MPG123_ADD_FLAGS, _MPG123_FORCE_FLOAT, ctypes.c_double(0.0)
        )
        if lib.mpg123_open(h, str(path).encode()) != _MPG123_OK:
            raise ValueError(f"{path}: mpg123 cannot open this file")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        if (
            lib.mpg123_getformat(
                h, ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(enc)
            )
            != _MPG123_OK
        ):
            raise ValueError(f"{path}: not a decodable MPEG audio stream")
        # force float32 output at the native rate/channels
        lib.mpg123_format_none(h)
        lib.mpg123_format(h, rate.value, channels.value, _MPG123_ENC_FLOAT_32)

        chunks = []
        buf = ctypes.create_string_buffer(65536)
        done = ctypes.c_size_t(0)
        first_rate = rate.value
        first_channels = channels.value
        while True:
            rc = lib.mpg123_read(h, buf, len(buf.raw), ctypes.byref(done))
            if done.value:
                chunks.append(
                    np.frombuffer(buf.raw[: done.value], np.float32).copy()
                )
            if rc == _MPG123_DONE:
                break
            if rc == _MPG123_NEW_FORMAT:
                lib.mpg123_getformat(
                    h, ctypes.byref(rate), ctypes.byref(channels),
                    ctypes.byref(enc),
                )
                if chunks and (
                    rate.value != first_rate
                    or channels.value != first_channels
                ):
                    # concatenated streams with a mid-stream rate/channel
                    # change cannot be represented as one (samples, rate)
                    # result; fail loudly instead of silently truncating
                    raise ValueError(
                        f"{path}: sample rate/channel change mid-stream "
                        f"({first_rate} Hz/{first_channels}ch -> "
                        f"{rate.value} Hz/{channels.value}ch) is unsupported"
                    )
                first_rate = rate.value
                first_channels = channels.value
                # re-enable float32 output for the (possibly new) format
                lib.mpg123_format_none(h)
                lib.mpg123_format(
                    h, rate.value, channels.value, _MPG123_ENC_FLOAT_32
                )
                continue
            if rc != _MPG123_OK:
                if chunks:
                    break  # salvage what decoded (mpg123 CLI does the same)
                raise ValueError(f"{path}: mpg123 decode failed (rc={rc})")
        ch = max(1, channels.value)
        x = (
            np.concatenate(chunks)
            if chunks
            else np.zeros(0, np.float32)
        )
        n_frames = len(x) // ch
        return x[: n_frames * ch].reshape(n_frames, ch), int(rate.value)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)


# ---------------------------------------------------------------------------
# MP3 encode (libmp3lame) — genuine Layer III fixtures + signal export
# ---------------------------------------------------------------------------


def mp3_encoder_available() -> bool:
    return _load("mp3lame") is not None


def write_mp3(
    path: Union[str, "os.PathLike"],
    samples: np.ndarray,
    rate: int,
    bitrate_kbps: int = 128,
    title: str = "",
) -> None:
    """Encode [n] or [n, channels<=2] float32 samples to a REAL MPEG-1/2
    Layer III file via libmp3lame (flat C ABI — no struct poking). A
    non-empty ``title`` writes a genuine ID3v2 tag at the stream head, the
    layout real recorders produce (the reference ingests these through
    AVFoundation, main.swift:63-76)."""
    lame = _load("mp3lame")
    if lame is None:
        raise RuntimeError("libmp3lame.so.0 is not available")

    samples = np.asarray(samples, np.float32)
    if samples.ndim == 1:
        samples = samples[:, None]
    n, channels = samples.shape
    if channels > 2:
        raise ValueError(f"MP3 supports at most 2 channels, got {channels}")

    lame.lame_init.restype = ctypes.c_void_p
    for fn in (
        "lame_set_in_samplerate", "lame_set_num_channels", "lame_set_brate",
        "lame_set_quality", "lame_init_params", "lame_close",
    ):
        getattr(lame, fn).restype = ctypes.c_int
        getattr(lame, fn).argtypes = [ctypes.c_void_p] + (
            [ctypes.c_int] if fn.startswith("lame_set") else []
        )
    lame.lame_encode_buffer_ieee_float.restype = ctypes.c_int
    lame.lame_encode_buffer_ieee_float.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    lame.lame_encode_flush.restype = ctypes.c_int
    lame.lame_encode_flush.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
    ]

    gf = lame.lame_init()
    if not gf:
        raise RuntimeError("lame_init failed")
    try:
        lame.lame_set_in_samplerate(gf, int(rate))
        lame.lame_set_num_channels(gf, channels)
        lame.lame_set_brate(gf, int(bitrate_kbps))
        lame.lame_set_quality(gf, 2)
        if title:
            lame.id3tag_init.argtypes = [ctypes.c_void_p]
            lame.id3tag_add_v2.argtypes = [ctypes.c_void_p]
            lame.id3tag_set_title.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lame.id3tag_init(gf)
            lame.id3tag_add_v2(gf)
            lame.id3tag_set_title(gf, title.encode())
        if lame.lame_init_params(gf) < 0:
            raise ValueError(
                f"lame rejected rate={rate}/channels={channels}/"
                f"bitrate={bitrate_kbps}"
            )
        # left/right columns MUST stay referenced through each C call
        # (`.ctypes.data` is a bare int — a temporary would be freed
        # mid-call, the measured ctypes trap)
        left = np.ascontiguousarray(samples[:, 0])
        right = np.ascontiguousarray(samples[:, 1] if channels == 2 else samples[:, 0])
        out = ctypes.create_string_buffer(int(1.25 * n + 7200) + 7200)
        with open(path, "wb") as fh:
            got = lame.lame_encode_buffer_ieee_float(
                gf,
                left.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                right.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                n,
                out,
                len(out),
            )
            if got < 0:
                raise ValueError(f"lame encode failed (rc={got})")
            fh.write(out.raw[:got])
            got = lame.lame_encode_flush(gf, out, len(out))
            if got > 0:
                fh.write(out.raw[:got])
        del left, right
    finally:
        lame.lame_close(gf)


# ---------------------------------------------------------------------------
# optional soundfile (libsndfile) — FLAC and everything else
# ---------------------------------------------------------------------------


def soundfile_available() -> bool:
    try:
        import soundfile  # noqa: F401

        return True
    except Exception:
        return False


def read_soundfile(path: Union[str, "os.PathLike"]) -> tuple[np.ndarray, int]:
    """Decode via the optional ``soundfile`` package (FLAC/OGG/CAF/...)."""
    try:
        import soundfile
    except Exception as e:
        raise RuntimeError(f"the soundfile package is not available: {e}") from e
    try:
        data, rate = soundfile.read(str(path), dtype="float32", always_2d=True)
    except Exception as e:
        raise ValueError(f"{path}: soundfile decode failed: {e}") from e
    return np.asarray(data, np.float32), int(rate)
