"""Minimal pure-numpy FITS reader/writer (the port's copy of
celeste_jl_tpu/io/fits.py).

Replaces the reference's cfitsio/FITSIO.jl dependency (SDSSIO.jl uses FITS
images + binary tables). Host-side I/O only; every array it returns is in
native byte order, so torch.as_tensor takes it as it is. Supports:
  * primary + IMAGE extensions, BITPIX 8/16/32/64/-32/-64, BSCALE/BZERO
  * BINTABLE extensions (L, B, I, J, K, E, D, A column types, with repeats)
  * header parsing incl. strings/booleans/ints/floats/comments
  * transparent .gz / .bz2 decompression and in-memory byte buffers
    (SDSSIO.jl:677-692 open_fits equivalent)
Writing supports image HDUs and simple BINTABLEs (enough for catalogs,
benchmark bundles and tests).
"""

import bz2
import gzip
import io as _io
import os
import re

import numpy as np

BLOCK = 2880
CARD = 80

_BITPIX_DTYPE = {
    8: np.dtype(">u1"), 16: np.dtype(">i2"), 32: np.dtype(">i4"),
    64: np.dtype(">i8"), -32: np.dtype(">f4"), -64: np.dtype(">f8"),
}
_DTYPE_BITPIX = {
    np.dtype("uint8"): 8, np.dtype("int16"): 16, np.dtype("int32"): 32,
    np.dtype("int64"): 64, np.dtype("float32"): -32, np.dtype("float64"): -64,
}
_TFORM_DTYPE = {
    "L": np.dtype("u1"), "B": np.dtype("u1"), "I": np.dtype(">i2"),
    "J": np.dtype(">i4"), "K": np.dtype(">i8"), "E": np.dtype(">f4"),
    "D": np.dtype(">f8"), "A": None,
}


class Header(dict):
    """FITS header: dict of KEY -> value plus ordered card list."""

    def __init__(self):
        super().__init__()
        self.cards = []  # (key, value, comment)

    def add(self, key, value, comment=""):
        self[key] = value
        self.cards.append((key, value, comment))


def _parse_value(raw):
    raw = raw.strip()
    if not raw:
        return None
    if raw.startswith("'"):
        # FITS string: '' escapes a quote; value ends at closing quote
        m = re.match(r"'((?:[^']|'')*)'", raw)
        return m.group(1).replace("''", "'").rstrip() if m else raw
    if raw == "T":
        return True
    if raw == "F":
        return False
    try:
        if re.fullmatch(r"[+-]?\d+", raw):
            return int(raw)
        return float(raw.replace("D", "E").replace("d", "e"))
    except ValueError:
        return raw


def _read_header(buf):
    hdr = Header()
    while True:
        block = buf.read(BLOCK)
        if len(block) < BLOCK:
            if not hdr.cards and not hdr:
                return None
            raise EOFError("truncated FITS header")
        text = block.decode("ascii", errors="replace")
        done = False
        for i in range(0, BLOCK, CARD):
            card = text[i:i + CARD]
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if not key or key in ("COMMENT", "HISTORY"):
                continue
            if card[8:10] == "= ":
                rest = card[10:]
                # split off comment ( / ), respecting quoted strings
                if rest.lstrip().startswith("'"):
                    m = re.match(r"\s*'(?:[^']|'')*'", rest)
                    vpart = rest[:m.end()] if m else rest
                    cpart = rest[m.end():] if m else ""
                    cpart = cpart.split("/", 1)[1] if "/" in cpart else ""
                else:
                    vpart, _, cpart = rest.partition("/")
                hdr.add(key, _parse_value(vpart), cpart.strip())
        if done:
            break
    return hdr


def _data_size(hdr):
    naxis = hdr.get("NAXIS", 0)
    if naxis == 0:
        return 0, []
    shape = [hdr[f"NAXIS{i}"] for i in range(1, naxis + 1)]
    n = int(np.prod(shape)) * abs(hdr["BITPIX"]) // 8
    pcount = hdr.get("PCOUNT", 0)
    gcount = hdr.get("GCOUNT", 1)
    return (n + pcount) * gcount, shape


class HDU:
    def __init__(self, header, data):
        self.header = header
        self.data = data


def _parse_tform(tform):
    m = re.match(r"(\d*)([LXBIJKAEDCMP])", tform.strip())
    rep = int(m.group(1)) if m.group(1) else 1
    return rep, m.group(2)


def _read_bintable(hdr, raw):
    nrows = hdr["NAXIS2"]
    rowbytes = hdr["NAXIS1"]
    tfields = hdr["TFIELDS"]
    names, fmts = [], []
    for i in range(1, tfields + 1):
        name = str(hdr.get(f"TTYPE{i}", f"col{i}")).strip()
        rep, code = _parse_tform(str(hdr[f"TFORM{i}"]))
        names.append(name)
        fmts.append((rep, code))
    # build numpy structured dtype
    fields = []
    for name, (rep, code) in zip(names, fmts):
        if code == "A":
            fields.append((name, f"S{rep}"))
        elif code == "X":
            fields.append((name, "u1", ((rep + 7) // 8,)))
        else:
            dt = _TFORM_DTYPE[code]
            fields.append((name, dt) if rep == 1 else (name, dt, (rep,)))
    dtype = np.dtype(fields)
    if dtype.itemsize != rowbytes:
        # fall back: read raw rows and slice manually (heap types etc.)
        raise ValueError(
            f"row size mismatch: dtype {dtype.itemsize} vs NAXIS1 {rowbytes}")
    table = np.frombuffer(raw[:nrows * rowbytes], dtype=dtype)
    out = {}
    for name, (rep, code) in zip(names, fmts):
        col = table[name]
        if code == "L":
            col = col == ord("T")
        elif code == "A":
            col = np.char.decode(col.astype("S"), "ascii")
        elif code in "IJKED":
            col = col.astype(col.dtype.newbyteorder("="))
        out[name] = np.array(col)
    # apply TSCAL/TZERO and TDIM per-row shapes
    for i, name in enumerate(names, start=1):
        tscal = hdr.get(f"TSCAL{i}", 1)
        tzero = hdr.get(f"TZERO{i}", 0)
        if (tscal, tzero) != (1, 0):
            out[name] = out[name] * tscal + tzero
        tdim = hdr.get(f"TDIM{i}")
        if tdim:
            # FITS lists dims fastest-first; numpy row shape reverses them
            dims = [int(d) for d in str(tdim).strip("() ").split(",")]
            out[name] = out[name].reshape(nrows, *dims[::-1])
    return out


def open_fits(path_or_bytes):
    """Read all HDUs. Accepts a path (with optional .gz/.bz2) or raw bytes."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        data = bytes(path_or_bytes)
        if data[:2] == b"\x1f\x8b":
            data = gzip.decompress(data)
        elif data[:3] == b"BZh":
            data = bz2.decompress(data)
        buf = _io.BytesIO(data)
    else:
        path = str(path_or_bytes)
        with open(path, "rb") as f:
            data = f.read()
        if path.endswith(".gz") or data[:2] == b"\x1f\x8b":
            data = gzip.decompress(data)
        elif path.endswith(".bz2") or data[:3] == b"BZh":
            data = bz2.decompress(data)
        buf = _io.BytesIO(data)

    hdus = []
    while True:
        try:
            hdr = _read_header(buf)
        except EOFError:
            break
        if hdr is None:
            break
        nbytes, shape = _data_size(hdr)
        raw = buf.read(((nbytes + BLOCK - 1) // BLOCK) * BLOCK)[:nbytes]
        data = None
        if nbytes:
            if str(hdr.get("XTENSION", "")).strip().startswith("BINTABLE"):
                data = _read_bintable(hdr, raw)
            else:
                dt = _BITPIX_DTYPE[hdr["BITPIX"]]
                arr = np.frombuffer(raw, dtype=dt)
                arr = arr.reshape(shape[::-1])  # FITS axis order is reversed
                arr = arr.astype(dt.newbyteorder("="))
                bscale = hdr.get("BSCALE", 1)
                bzero = hdr.get("BZERO", 0)
                if (bscale, bzero) != (1, 0):
                    arr = arr * bscale + bzero
                data = arr
        hdus.append(HDU(hdr, data))
        if buf.tell() >= len(buf.getvalue()):
            break
    return hdus


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def _format_card(key, value, comment=""):
    if isinstance(value, bool):
        v = "T" if value else "F"
        card = f"{key:<8}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        card = f"{key:<8}= {value:>20d}"
    elif isinstance(value, (float, np.floating)):
        card = f"{key:<8}= {value:>20.13E}"
    elif value is None:
        card = f"{key:<8}="
    else:
        s = "'" + str(value).replace("'", "''") + "'"
        card = f"{key:<8}= {s:<20}"
    if comment:
        card += f" / {comment}"
    return card[:CARD].ljust(CARD)


def _pad(b):
    return b + b"\x00" * ((-len(b)) % BLOCK)


def _header_bytes(cards):
    text = "".join(_format_card(*c) for c in cards) + "END".ljust(CARD)
    text += " " * ((-len(text)) % BLOCK)
    return text.encode("ascii")


def write_fits(path, hdus):
    """hdus: list of (data, extra_header_items). data may be None, an
    ndarray (image), or a dict of column name -> 1-D array (bintable)."""
    out = b""
    for i, (data, extra) in enumerate(hdus):
        primary = i == 0
        cards = []
        if isinstance(data, dict):
            out += _bintable_bytes(data, extra, primary)
            continue
        if primary:
            cards.append(("SIMPLE", True, "file conforms to FITS standard"))
        else:
            cards.append(("XTENSION", "IMAGE", "image extension"))
        if data is None:
            cards += [("BITPIX", 8, ""), ("NAXIS", 0, "")]
        else:
            data = np.asarray(data)
            bitpix = _DTYPE_BITPIX[data.dtype]
            cards += [("BITPIX", bitpix, ""), ("NAXIS", data.ndim, "")]
            for ax, n in enumerate(reversed(data.shape), start=1):
                cards.append((f"NAXIS{ax}", int(n), ""))
        if not primary:
            cards += [("PCOUNT", 0, ""), ("GCOUNT", 1, "")]
        for item in (extra or []):
            cards.append(item if len(item) == 3 else (*item, ""))
        out += _header_bytes(cards)
        if data is not None:
            be = data.astype(data.dtype.newbyteorder(">"))
            out += _pad(be.tobytes())
    with open(path, "wb") as f:
        f.write(out)


def _bintable_bytes(columns, extra, primary):
    if primary:
        # bintables cannot be primary; emit an empty primary first
        head = _header_bytes([("SIMPLE", True, ""), ("BITPIX", 8, ""),
                              ("NAXIS", 0, "")])
    else:
        head = b""
    names = list(columns)
    arrs = [np.asarray(columns[n]) for n in names]
    nrows = len(arrs[0]) if arrs else 0
    fields, tforms, tdims = [], [], []
    for n, a in zip(names, arrs):
        if a.dtype.kind in "US":
            width = int(a.dtype.itemsize // (4 if a.dtype.kind == "U" else 1))
            fields.append((n, f"S{width}"))
            tforms.append(f"{width}A")
            tdims.append(None)
        elif a.dtype.kind == "b":
            fields.append((n, "u1"))
            tforms.append("1L")
            tdims.append(None)
        else:
            code = {"i2": "I", "i4": "J", "i8": "K",
                    "f4": "E", "f8": "D"}[a.dtype.str[1:]]
            be = a.dtype.newbyteorder(">")
            if a.ndim > 1:
                # array-valued column: repeat = row size, TDIM records the
                # per-row shape in FITS (fastest-first) axis order
                rep = int(np.prod(a.shape[1:]))
                fields.append((n, be, (rep,)))
                tforms.append(f"{rep}{code}")
                tdims.append("(" + ",".join(str(d) for d
                                            in a.shape[1:][::-1]) + ")")
            else:
                fields.append((n, be))
                tforms.append(f"1{code}")
                tdims.append(None)
    dtype = np.dtype(fields)
    table = np.zeros(nrows, dtype=dtype)
    for n, a in zip(names, arrs):
        if a.dtype.kind == "b":
            table[n] = np.where(a, ord("T"), ord("F"))
        elif a.dtype.kind == "U":
            table[n] = a.astype(f"S{dtype[n].itemsize}")
        elif a.ndim > 1:
            table[n] = a.reshape(nrows, -1)
        else:
            table[n] = a
    cards = [("XTENSION", "BINTABLE", "binary table"), ("BITPIX", 8, ""),
             ("NAXIS", 2, ""), ("NAXIS1", dtype.itemsize, ""),
             ("NAXIS2", nrows, ""), ("PCOUNT", 0, ""), ("GCOUNT", 1, ""),
             ("TFIELDS", len(names), "")]
    for i, (n, tf) in enumerate(zip(names, tforms), start=1):
        cards.append((f"TTYPE{i}", n, ""))
        cards.append((f"TFORM{i}", tf, ""))
        if tdims[i - 1] is not None:
            cards.append((f"TDIM{i}", tdims[i - 1], ""))
    for item in (extra or []):
        cards.append(item if len(item) == 3 else (*item, ""))
    return head + _header_bytes(cards) + _pad(table.tobytes())
