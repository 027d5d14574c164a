"""Writers of the still-image forms that cv2 and PIL do not write (or not
in every variant): PNG at any depth and colour type, with any row filter,
Adam7 interlacing and chunks before or after the image data; BMP with any
header, depth, palette, RLE8 / RLE4 stream and row direction; baseline
TIFF in either byte order, in strips or tiles, with each compression and
predictor; a two-frame MPO.  Tests and ``chip_smoke.py`` [19] write their
inputs with them, then take cv2's and PIL's decodes of those files as the
expected values.  numpy, ``zlib`` and ``struct`` only.
"""

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def pack_bits(samples, bits, order=">"):
    """(h, w, c) integer samples -> (h, row bytes) uint8, rows padded to a
    byte (16-bit samples in ``order``)."""
    s = np.asarray(samples)
    h = s.shape[0]
    if bits == 16:
        return s.astype(order + "u2").reshape(h, -1).view(np.uint8).reshape(h, -1)
    flat = s.reshape(h, -1).astype(np.uint8)
    if bits == 8:
        return flat
    per = 8 // bits
    nb = -(-flat.shape[1] // per)
    pad = np.zeros((h, nb * per), np.uint8)
    pad[:, :flat.shape[1]] = flat
    pad = pad.reshape(h, nb, per)
    out = np.zeros((h, nb), np.uint8)
    for i in range(per):
        out |= pad[:, :, i] << (8 - bits * (i + 1))
    return out


# ---------------------------------------------------------------- PNG

def png_chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filter_rows(rows, bpp, filters):
    """Filter each row with filters[i % len(filters)] (0-4)."""
    h = rows.shape[0]
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for i in range(h):
        f = filters[i % len(filters)]
        x = rows[i].astype(np.int32)
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]]) if x.size > bpp else \
            np.zeros_like(x)
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]]) if x.size > bpp else \
            np.zeros_like(x)
        b = prev
        if f == 0:
            pred = 0
        elif f == 1:
            pred = a
        elif f == 2:
            pred = b
        elif f == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out.append(bytes([f]) + ((x - pred) & 255).astype(np.uint8).tobytes())
        prev = x
    return b"".join(out)


def png(samples, depth, ctype, interlace=False, filters=(0,), palette=None, trns=None,
        before=(), after=()):
    """PNG bytes of (h, w[, c]) samples at ``depth`` and colour type
    ``ctype``; ``before`` / ``after``: (type, body) chunks around IDAT."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    h, w, c = s.shape
    bpp = max(1, c * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = s[y0::dy, x0::dx]
        if sub.size:
            raw += _filter_rows(pack_bits(sub, depth), bpp, filters)
    out = PNG_SIGNATURE + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                         int(interlace)))
    out += b"".join(png_chunk(k, b) for k, b in before)
    if palette is not None:
        out += png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += png_chunk(b"tRNS", trns)
    out += png_chunk(b"IDAT", zlib.compress(raw, 6))
    return out + b"".join(png_chunk(k, b) for k, b in after) + png_chunk(b"IEND", b"")


def exif_tiff(orientation, order="<"):
    """An EXIF block's TIFF structure with IFD0 holding the orientation."""
    return ((b"II*\x00" if order == "<" else b"MM\x00*") + struct.pack(order + "IH", 8, 1)
            + struct.pack(order + "HHIHH", 0x0112, 3, 1, orientation, 0) + b"\x00" * 4)


# ---------------------------------------------------------------- BMP

def rle8(indices):
    """RLE8 of (h, w) indices in bottom-up file order: encoded runs of up
    to 255, an end of line after each row, an end of bitmap."""
    out = bytearray()
    for row in np.asarray(indices, np.uint8)[::-1]:
        starts = np.flatnonzero(np.concatenate([[True], row[1:] != row[:-1]]))
        lengths = np.diff(np.concatenate([starts, [row.size]]))
        for st, n in zip(starts.tolist(), lengths.tolist()):
            while n:
                k = min(n, 255)
                out += bytes([k, row[st]])
                n -= k
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def bmp(px=None, bits=24, header=40, palette=None, top_down=False, compression=0, masks=None,
        rle=None, size=None, colors=None):
    """BMP bytes: ``px`` (h, w) indices (1-8 bits), (h, w) uint16 (16
    bits), (h, w, 3|4) BGR(A) bytes (24 / 32 bits), or an ``rle`` stream
    for ``size`` (w, h); ``palette`` RGB rows; ``masks`` for BITFIELDS."""
    if rle is not None:
        w, h = size
        data = rle
    else:
        h, w = np.asarray(px).shape[:2]
        stride = ((w * bits + 31) // 32) * 4
        if bits <= 8:
            rows = pack_bits(np.asarray(px)[..., None], bits)
        elif bits == 16:
            rows = np.asarray(px, "<u2").reshape(h, -1).view(np.uint8).reshape(h, -1)
        else:
            rows = np.asarray(px, np.uint8).reshape(h, -1)
        full = np.zeros((h, stride), np.uint8)
        full[:, :rows.shape[1]] = rows
        data = (full if top_down else full[::-1]).tobytes()
    entry = 3 if header == 12 else 4
    pal = b"" if palette is None else b"".join(
        bytes([b, g, r]) + b"\x00" * (entry - 3) for r, g, b in np.asarray(palette).tolist())
    if header == 12:
        head = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        n = colors if colors is not None else (
            len(palette) if palette is not None and len(palette) != 1 << bits else 0)
        head = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits,
                           compression, len(data), 2835, 2835, n, 0)
        if header == 40 and compression == 3:
            head += struct.pack("<III", *masks[:3])
        elif header > 40:
            m = list(masks or (0, 0, 0, 0)) + [0, 0, 0, 0]
            head += struct.pack("<IIII", *m[:4]) + b"BGRs" + b"\x00" * 48
            head += b"\x00" * 16 if header == 124 else b""
    offset = 14 + len(head) + len(pal)
    return b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset) + head + pal + data


# ---------------------------------------------------------------- TIFF

def lzw(data):
    """TIFF LZW (MSB first, early change, a Clear first and when the table
    fills)."""
    res, acc, nacc, nbits = bytearray(), 0, 0, 9

    def put(code):
        nonlocal acc, nacc
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            res.append((acc >> (nacc - 8)) & 255)
            nacc -= 8
        acc &= (1 << nacc) - 1

    table, nxt = {bytes([i]): i for i in range(256)}, 258
    put(256)
    w = b""
    for ch in data:
        wc = w + bytes([ch])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = nxt
        nxt += 1
        if nxt == 4094:
            put(256)
            table, nxt, nbits = {bytes([i]): i for i in range(256)}, 258, 9
        elif nxt in (512, 1024, 2048):
            nbits += 1
        w = bytes([ch])
    if w:
        put(table[w])
        nxt += 1
        if nxt in (512, 1024, 2048):
            nbits += 1
    put(257)
    if nacc:
        res.append((acc << (8 - nacc)) & 255)
    return bytes(res)


def packbits(data):
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([(257 - (j - i + 1)) & 255, data[i]])
            i = j + 1
        else:
            j = i + 1
            while j < n and j - i < 128 and not (j + 1 < n and data[j + 1] == data[j]):
                j += 1
            out += bytes([j - i - 1]) + bytes(data[i:j])
            i = j
    return bytes(out)


def _predict(rows, c, bits, order):
    h = rows.shape[0]
    if bits == 8:
        a = rows.reshape(h, -1, c).astype(np.int64)
        d = a.copy()
        d[:, 1:] -= a[:, :-1]
        return (d & 255).astype(np.uint8).reshape(h, -1)
    a = rows.view(order + "u2").reshape(h, -1, c).astype(np.int64)
    d = a.copy()
    d[:, 1:] -= a[:, :-1]
    return (d & 65535).astype(order + "u2").reshape(h, -1).view(np.uint8).reshape(h, -1)


def tiff(samples, bits=8, photometric=2, order="<", compression=1, predictor=1,
         rows_per_strip=None, tile=None, extra=None, colormap=None, orientation=None,
         extra_tags=()):
    """TIFF bytes of (h, w[, c]) samples; ``colormap`` (2**bits, 3) 16-bit
    RGB rows; ``tile`` (th, tw); ``extra_tags`` (tag, type, values)."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    h, w, c = s.shape
    comp = {1: lambda r: r, 5: lzw, 8: zlib.compress, 32946: zlib.compress,
            32773: packbits}[compression]

    def chunk(part):
        rows = pack_bits(part, bits, order)
        if predictor == 2:
            rows = _predict(rows, c, bits, order)
        return comp(rows.tobytes())

    if tile is None:
        rps = rows_per_strip or h
        chunks = [chunk(s[y:y + rps]) for y in range(0, h, rps)]
    else:
        th, tw = tile
        chunks = []
        for y in range(0, h, th):
            for x in range(0, w, tw):
                t = np.zeros((th, tw, c), s.dtype)
                part = s[y:y + th, x:x + tw]
                t[:part.shape[0], :part.shape[1]] = part
                chunks.append(chunk(t))
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * c), (259, 3, [compression]),
            (262, 3, [photometric]), (277, 3, [c])]
    if orientation:
        tags.append((274, 3, [orientation]))
    if predictor != 1:
        tags.append((317, 3, [predictor]))
    if colormap is not None:
        tags.append((320, 3, np.asarray(colormap).T.ravel().tolist()))
    if extra is not None:
        tags.append((338, 3, list(extra)))
    tags += list(extra_tags)
    data, offsets, counts = b"", [], []
    for ch in chunks:
        offsets.append(8 + len(data))
        counts.append(len(ch))
        data += ch + b"\x00" * (len(ch) % 2)
    if tile is None:
        tags += [(273, 4, offsets), (278, 4, [rps]), (279, 4, counts)]
    else:
        tags += [(322, 3, [tile[1]]), (323, 3, [tile[0]]), (324, 4, offsets), (325, 4, counts)]
    tags.sort(key=lambda t: t[0])
    ifd_at = 8 + len(data)
    ext_at = ifd_at + 2 + 12 * len(tags) + 4
    ifd, ext = struct.pack(order + "H", len(tags)), b""
    for tag, typ, vals in tags:
        payload = struct.pack(order + {3: "H", 4: "I"}[typ] * len(vals), *vals)
        if len(payload) <= 4:
            ifd += struct.pack(order + "HHI", tag, typ, len(vals)) + payload.ljust(4, b"\x00")
        else:
            ifd += struct.pack(order + "HHII", tag, typ, len(vals), ext_at + len(ext))
            ext += payload + b"\x00" * (len(payload) % 2)
    head = (b"II*\x00" if order == "<" else b"MM\x00*") + struct.pack(order + "I", ifd_at)
    return head + data + ifd + struct.pack(order + "I", 0) + ext


# ---------------------------------------------------------------- MPO

def mpo(frames):
    """An MPO of baseline JPEG frames (bytes): the first frame carries an
    APP2 MPF segment (big-endian MP index: version, count, one entry a
    frame with its size and offset from the MPF header)."""
    n = len(frames)
    entries_at = 8 + 2 + 12 * 3 + 4            # the MP entries after the IFD
    app2_len = 2 + 4 + entries_at + 16 * n     # its length field counts itself

    def segment(offsets):
        ifd = struct.pack(">H", 3)
        ifd += struct.pack(">HHI4s", 0xB000, 7, 4, b"0100")
        ifd += struct.pack(">HHII", 0xB001, 4, 1, n)
        ifd += struct.pack(">HHII", 0xB002, 7, 16 * n, entries_at) + struct.pack(">I", 0)
        ents = b"".join(struct.pack(">IIIHH", 0x20030000 if i == 0 else 0x00020002,
                                    len(f) + (app2_len + 2 if i == 0 else 0), offsets[i], 0, 0)
                        for i, f in enumerate(frames))
        body = b"MPF\x00" + b"MM\x00*" + struct.pack(">I", 8) + ifd + ents
        return b"\xff\xe2" + struct.pack(">H", len(body) + 2) + body

    first = frames[0]
    head_len = 2 + app2_len + 2 + len(first) - 2   # SOI, APP2, the rest of frame 0
    mpf_at = 2 + 4 + 4                             # the MPF TIFF header in the file
    offsets, pos = [0], head_len
    for f in frames[1:]:
        offsets.append(pos - mpf_at)
        pos += len(f)
    return first[:2] + segment(offsets) + first[2:] + b"".join(frames[1:])
