"""Audio file reader/writer (the framework's AVFoundation-decode equivalent).

The reference decodes audio through AVAssetReader into float32 non-interleaved
PCM — any container AVFoundation can read (reference:
Common/SyllableDetector.swift:19-23, SyllableDetectorCLI/main.swift:63-76);
here WAV is parsed directly (PCM 8/16/24/32-bit, IEEE float32/64,
WAVE_FORMAT_EXTENSIBLE) and AIFF/AIFC and Sun AU ride the stdlib decoders.
Integers normalize to [-1, 1) with the CoreAudio convention (int16 / 32768
etc.). No external dependencies.

:func:`_pcm16_layout` finds where a 16-bit PCM WAV keeps its codes, for a
caller that reads them as they are and scales them elsewhere (the corpus
scan, on the device: its native piece reader reads them, or, where that
cannot be built, :func:`_read_range_into` in one range);
:func:`_read_pcm16_into` reads the whole chunk into a buffer the caller
gives.
"""

from __future__ import annotations

import io
import os
import stat
import struct
import sys
import warnings
from typing import Optional, Union

import numpy as np

__all__ = ["read_audio", "read_wav", "write_wav"]

_PCM = 1
_IEEE_FLOAT = 3
_EXTENSIBLE = 0xFFFE


def _wav_layout(fh, path) -> tuple[bytes, int, int]:
    """Walk the chunks of the RIFF/WAVE file open in ``fh`` by their
    headers: (the last ``fmt `` chunk's payload, the last ``data`` chunk's
    offset in the file, the bytes of it the file holds). A chunk's odd size
    is followed by a pad byte; a chunk cut short by the end of the file ends
    the walk. Only ``fmt ``'s payload is read."""
    header = fh.read(12)
    if len(header) < 12:
        raise ValueError(f"{path}: truncated WAV header")
    riff, _size, wave_id = struct.unpack("<4sI4s", header)
    if riff != b"RIFF" or wave_id != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    end = fh.seek(0, os.SEEK_END)
    fmt, data, pos = None, None, 12
    while pos + 8 <= end:
        fh.seek(pos)
        chunk_id, chunk_size = struct.unpack("<4sI", fh.read(8))
        pos += 8
        if chunk_id == b"fmt ":
            fmt = fh.read(chunk_size)
        elif chunk_id == b"data":
            data = (pos, min(chunk_size, end - pos))
        pos += chunk_size + chunk_size % 2  # chunks are word-aligned
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    return fmt, *data


def _wav_format(fmt: bytes, path) -> tuple[int, int, int, int, int]:
    """A ``fmt `` payload -> (format code, channels, rate, block align,
    bits); WAVE_FORMAT_EXTENSIBLE gives its subformat's code."""
    if len(fmt) < 16:
        raise ValueError(f"{path}: truncated fmt chunk")
    (audio_format, channels, rate, _byte_rate, block_align, bits) = struct.unpack(
        "<HHIIHH", fmt[:16]
    )
    if channels < 1 or block_align < 1:
        raise ValueError(f"{path}: invalid fmt chunk")
    if audio_format == _EXTENSIBLE:
        # subformat GUID's first two bytes carry the real format code
        if len(fmt) < 26:
            raise ValueError(f"{path}: truncated WAVE_FORMAT_EXTENSIBLE fmt chunk")
        audio_format = struct.unpack("<H", fmt[24:26])[0]
    return audio_format, channels, int(rate), block_align, bits


def read_wav(path: Union[str, "os.PathLike"]) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (samples [n, channels] float32 in [-1, 1], rate)."""
    with open(path, "rb") as fh:
        if not fh.seekable():  # a pipe: walked in memory
            fh = io.BytesIO(fh.read())
        fmt, offset, length = _wav_layout(fh, path)
        fh.seek(offset)
        data = fh.read(length)
    audio_format, channels, rate, block_align, bits = _wav_format(fmt, path)

    n_frames = len(data) // block_align
    data = data[: n_frames * block_align]

    if audio_format == _PCM:
        if bits == 16:
            x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
            as32 = (
                raw[:, 0].astype(np.uint32)
                | (raw[:, 1].astype(np.uint32) << 8)
                | (raw[:, 2].astype(np.uint32) << 16)
            )
            signed = as32.astype(np.int32)
            signed = np.where(signed >= 1 << 23, signed - (1 << 24), signed)
            x = signed.astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == _IEEE_FLOAT:
        if bits == 32:
            x = np.frombuffer(data, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(data, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"{path}: unsupported float bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAV format code {audio_format}")

    return x.reshape(n_frames, channels), rate


def _pcm16_layout(fh, path, capacity: int) -> Optional[tuple[int, int, int, int]]:
    """Where a 16-bit PCM WAV open unbuffered in ``fh`` keeps its codes:
    (the data chunk's offset in the file, the bytes of it the file holds,
    channels, rate), walked as :func:`read_wav` walks it
    (:func:`_wav_layout`, :func:`_wav_format`), so the codes are those that
    :func:`read_wav` divides by 32768, frame for frame. None for every file
    :func:`read_wav` would not decode as 16-bit PCM (WAVE_FORMAT_EXTENSIBLE
    with a PCM subformat included) or would refuse, whose data chunk is
    longer than ``capacity`` bytes, that is not a regular file, on a
    big-endian host, and where positional reads (``os.preadv``) are
    missing. Raises OSError where the file cannot be read."""
    if sys.byteorder != "little" or not hasattr(os, "preadv"):
        return None
    if not stat.S_ISREG(os.fstat(fh.fileno()).st_mode):
        return None
    try:
        fmt, offset, length = _wav_layout(fh, path)
        audio_format, channels, rate, block_align, bits = _wav_format(fmt, path)
    except ValueError:
        return None
    if audio_format != _PCM or bits != 16 or block_align != 2 * channels or length > capacity:
        return None
    return offset, length, channels, rate


def _read_range_into(fd: int, view: memoryview, offset: int) -> int:
    """Fill the writable byte ``view`` from the file ``fd`` at ``offset``
    by positional reads, which move no file position and release the
    interpreter lock: the bytes read, fewer only where the file ends
    first."""
    got = 0
    while got < len(view) and (n := os.preadv(fd, [view[got:]], offset + got)):
        got += n
    return got


def _read_pcm16_into(path, buffer) -> Optional[tuple[int, int, int]]:
    """Read a 16-bit PCM WAV's data chunk as it is, little-endian int16
    codes frame after frame, into the writable ``buffer`` in one range
    (:func:`_pcm16_layout`, :func:`_read_range_into`): (the bytes of the
    whole frames read, channels, rate). Returns None, with no sample read,
    for every file :func:`_pcm16_layout` refuses, among them one whose data
    chunk does not fit ``buffer``. Raises OSError where the file cannot be
    opened.
    """
    view = memoryview(buffer).cast("B")
    with open(path, "rb", buffering=0) as fh:
        layout = _pcm16_layout(fh, path, len(view))
        if layout is None:
            return None
        offset, length, channels, rate = layout
        got = _read_range_into(fh.fileno(), view[:length], offset)
    return got - got % (2 * channels), channels, rate


def _pcm_bytes_to_float(data: bytes, sampwidth: int, big_endian: bool) -> np.ndarray:
    """Integer PCM bytes -> float32 in [-1, 1)."""
    if sampwidth == 1:
        return np.frombuffer(data, dtype=np.int8).astype(np.float32) / 128.0
    if sampwidth == 2:
        dt = ">i2" if big_endian else "<i2"
        return np.frombuffer(data, dtype=dt).astype(np.float32) / 32768.0
    if sampwidth == 4:
        dt = ">i4" if big_endian else "<i4"
        return np.frombuffer(data, dtype=dt).astype(np.float32) / 2147483648.0
    if sampwidth == 3:
        raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        if big_endian:
            raw = raw[:, ::-1]
        as32 = (
            raw[:, 0].astype(np.uint32)
            | (raw[:, 1].astype(np.uint32) << 8)
            | (raw[:, 2].astype(np.uint32) << 16)
        )
        signed = as32.astype(np.int32)
        signed = np.where(signed >= 1 << 23, signed - (1 << 24), signed)
        return signed.astype(np.float32) / 8388608.0
    raise ValueError(f"unsupported PCM sample width {sampwidth}")


def _stdlib_decoder(module_name: str):
    """Import aifc/sunau (removed from the stdlib in Python 3.13, PEP 594);
    map absence to the ValueError every ingest caller already handles."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return __import__(module_name)
    except ImportError as e:
        raise ValueError(
            f"the stdlib {module_name!r} decoder is unavailable on this "
            f"Python ({e}); convert the file to WAV"
        ) from e


def _read_stdlib(path, module_name: str):
    """AIFF/AIFC ('aifc') and Sun AU ('sunau') via the stdlib decoders.

    Both return linear PCM frames as the container's raw big-endian bytes;
    sunau's ULAW path instead decodes via audioop.ulaw2lin, which emits
    NATIVE-endian int16 (verified against CPython's sunau.readframes).
    """
    import sys as _sys

    mod = _stdlib_decoder(module_name)
    try:
        f = mod.open(str(path), "rb")
        try:
            channels = f.getnchannels()
            rate = int(f.getframerate())
            sampwidth = f.getsampwidth()
            comptype = f.getcomptype()
            data = f.readframes(f.getnframes())
        finally:
            f.close()
    except (mod.Error, EOFError) as e:
        # decode failures (truncated container, unsupported codec) must keep
        # the ValueError contract read_audio documents — every ingest caller
        # catches (OSError, ValueError) to skip-and-continue per file
        raise ValueError(f"{path}: {module_name} decode failed: {e}") from e
    if channels < 1:
        raise ValueError(f"{path}: invalid channel count {channels}")
    if isinstance(comptype, bytes):
        comptype = comptype.decode(errors="replace")
    # aifc spells them 'ulaw'/'alaw', sunau 'ULAW' — all audioop-decoded
    decoded_native = comptype.upper() in ("ULAW", "ALAW")
    big_endian = (_sys.byteorder == "big") if decoded_native else True
    x = _pcm_bytes_to_float(data, sampwidth, big_endian)
    n_frames = len(x) // channels
    return x[: n_frames * channels].reshape(n_frames, channels), rate


def read_audio(path: Union[str, "os.PathLike"]) -> tuple[np.ndarray, int]:
    """Read any supported audio container -> ([n, channels] float32, rate).

    Sniffs the magic bytes: RIFF/WAVE (native parser), FORM/AIFF+AIFC
    (stdlib aifc), .snd/AU (stdlib sunau), OggS (libvorbisfile via ctypes),
    ID3/MPEG-sync (libmpg123 via ctypes), ftyp/MP4+M4A, fLaC, caff and
    ADTS AAC via the native FFmpeg shim (utils.av_codec), with the
    optional ``soundfile`` package as a further fallback. The
    multi-container surface of the reference CLI's AVAssetReader ingest
    (main.swift:63-76).
    """
    with open(path, "rb") as fh:
        head = fh.read(12)
    magic = head[:4]
    if magic == b"RIFF":
        return read_wav(path)
    if magic == b"FORM":
        return _read_stdlib(path, "aifc")
    if magic == b".snd":
        return _read_stdlib(path, "sunau")

    from syllable_detector_tpu_torch.utils import av_codec, codecs

    # MP4-family (M4A/AAC/ALAC: 'ftyp' box at offset 4,
    # main.swift:63-76's most common recorder format after WAV/MP3),
    # FLAC, CAF, and raw ADTS AAC (sync 0xFFF with layer 00) all route
    # through the native FFmpeg shim first
    is_adts_aac = (
        len(head) >= 2 and head[0] == 0xFF and (head[1] & 0xF6) == 0xF0
    )
    if head[4:8] == b"ftyp" or magic in (b"fLaC", b"caff") or is_adts_aac:
        if av_codec.av_available():
            return av_codec.read_av(path)
        if codecs.soundfile_available():
            return codecs.read_soundfile(path)
        raise ValueError(
            f"{path}: compressed container (magic {magic!r}) but neither "
            f"the native FFmpeg shim nor the soundfile package is available"
        )

    if magic == b"OggS":
        if codecs.ogg_vorbis_available():
            return codecs.read_ogg_vorbis(path)
        if codecs.soundfile_available():
            return codecs.read_soundfile(path)
        raise ValueError(
            f"{path}: OGG container but neither libvorbisfile nor the "
            f"soundfile package is available"
        )
    # MPEG audio frame sync: 0xFF + top 3 bits of byte 1, with the fields a
    # real MPEG *audio* header cannot zero out — layer != 00 (ADTS AAC has
    # layer 00), bitrate index != 1111, sampling index != 11. A stray
    # 0xFF-leading file (UTF-16 BOM etc.) still cannot be fully excluded
    # from 4 bytes, so decoder failures fall through to soundfile below.
    is_mpeg_sync = (
        len(magic) >= 4
        and magic[0] == 0xFF
        and (magic[1] & 0xE0) == 0xE0
        and (magic[1] >> 1) & 0x3 != 0  # layer
        and (magic[2] >> 4) != 0xF  # bitrate index
        and (magic[2] >> 2) & 0x3 != 0x3  # sampling index
    )
    if magic[:3] == b"ID3" or is_mpeg_sync:
        # MP3: ID3v2 tag or a bare MPEG audio frame sync
        if codecs.mp3_available():
            try:
                return codecs.read_mp3(path)
            except ValueError:
                if not codecs.soundfile_available():
                    raise
        if codecs.soundfile_available():
            return codecs.read_soundfile(path)
        raise ValueError(
            f"{path}: MPEG audio but neither libmpg123 nor the soundfile "
            f"package is available"
        )
    if av_codec.av_available():
        # anything else FFmpeg can demux (the AVFoundation-width route)
        try:
            return av_codec.read_av(path)
        except ValueError:
            pass
    if codecs.soundfile_available():
        # FLAC/CAF/anything libsndfile knows
        try:
            return codecs.read_soundfile(path)
        except ValueError:
            pass
    raise ValueError(f"{path}: unsupported audio container (magic {magic!r})")


def write_wav(
    path: Union[str, "os.PathLike"],
    samples: np.ndarray,
    rate: int,
    dtype: str = "int16",
) -> None:
    """Write [n] or [n, channels] samples; dtype 'int16' or 'float32'."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    n, channels = samples.shape

    if dtype == "int16":
        fmt_code, bits = _PCM, 16
        clipped = np.clip(samples.astype(np.float64) * 32768.0, -32768, 32767)
        payload = clipped.astype("<i2").tobytes()
    elif dtype == "float32":
        fmt_code, bits = _IEEE_FLOAT, 32
        payload = samples.astype("<f4").tobytes()
    else:
        raise ValueError(f"unsupported dtype {dtype}")

    block_align = channels * bits // 8
    byte_rate = rate * block_align
    fmt_chunk = struct.pack("<HHIIHH", fmt_code, channels, rate, byte_rate, block_align, bits)
    body = b"WAVE"
    body += b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
    body += b"data" + struct.pack("<I", len(payload)) + payload
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(body)) + body)
