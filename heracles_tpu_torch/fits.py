"""Minimal pure-Python FITS binary-table I/O.

Carried over unchanged from :mod:`heracles_tpu.fits`, so that files
written by either package read the same in the other.  Implements the
subset the package needs, with no ``fitsio`` or astropy:

* primary HDU + any number of BINTABLE extensions,
* scalar and vector (TDIM) columns of logical/integer/float/complex types,
* header keys of any length (HIERARCH convention), strings, bools,
  ints, floats, plus comments,
* random access by extension name or index, column + row-range reads
  (for paged catalogues), appending extensions to existing files.

Byte layout follows the FITS 4.0 standard: 2880-byte blocks, 80-char
ASCII header cards, big-endian table payloads.
"""

from __future__ import annotations

import mmap
import os
import re
import threading

import numpy as np

__all__ = ["FitsFile", "Header", "TableHDU"]

BLOCK = 2880

# numpy kind/itemsize -> TFORM letter
_TFORM_OF = {
    ("b", 1): "L",
    ("u", 1): "B",
    ("i", 2): "I",
    ("i", 4): "J",
    ("i", 8): "K",
    ("f", 4): "E",
    ("f", 8): "D",
    ("c", 8): "C",
    ("c", 16): "M",
}
_DTYPE_OF = {v: k for k, v in _TFORM_OF.items()}
_TFORM_BYTES = {"L": 1, "B": 1, "I": 2, "J": 4, "K": 8, "E": 4, "D": 8, "C": 8, "M": 16, "A": 1}


class Header:
    """Ordered FITS header: mapping-like with per-key comments."""

    def __init__(self, items=None):
        self._keys = []
        self._values = {}
        self._comments = {}
        if items:
            for k, v in dict(items).items():
                self[k] = v

    def __contains__(self, key):
        return key.upper() in self._values

    def __getitem__(self, key):
        return self._values[key.upper()]

    def get(self, key, default=None):
        return self._values.get(key.upper(), default)

    def __setitem__(self, key, value):
        key = key.upper()
        if key not in self._values:
            self._keys.append(key)
        if isinstance(value, tuple):
            value, comment = value
            self._comments[key] = comment
        self._values[key] = value

    def set(self, key, value, comment=None):
        self[key] = (value, comment) if comment is not None else value

    def keys(self):
        return list(self._keys)

    def items(self):
        return [(k, self._values[k]) for k in self._keys]

    def get_comment(self, key):
        return self._comments.get(key.upper(), "")

    def __iter__(self):
        return iter(self._keys)

    def __len__(self):
        return len(self._keys)


def _format_value(value):
    if isinstance(value, bool) or isinstance(value, np.bool_):
        return "T" if value else "F"
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    if isinstance(value, (float, np.floating)):
        r = repr(float(value))
        return r.replace("e", "E").replace("inf", "INF").replace("nan", "NAN")
    if isinstance(value, (complex, np.complexfloating)):
        return f"({value.real!r}, {value.imag!r})"
    # string
    s = str(value).replace("'", "''")
    return "'" + s.ljust(8) + "'"


def _make_card(key, value, comment=""):
    key = key.upper()
    if len(key) <= 8 and re.fullmatch(r"[A-Z0-9_-]*", key):
        head = f"{key:<8}= "
    else:
        head = f"HIERARCH {key} = "
    val = _format_value(value)
    if not head.startswith("HIERARCH") and not isinstance(value, str):
        val = val.rjust(20)
    card = head + val
    if comment:
        card += " / " + comment
    if len(card) > 80:
        card = card[:80]
    return card.ljust(80)


def _comment_card(kind, text):
    return f"{kind:<8}{text}"[:80].ljust(80)


_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([ED][+-]?\d+)?$", re.I)


def _parse_value(raw):
    raw = raw.strip()
    if not raw:
        return None
    if raw.startswith("'"):
        # string: find closing quote, handling '' escapes
        body = raw[1:]
        out = []
        i = 0
        while i < len(body):
            if body[i] == "'":
                if i + 1 < len(body) and body[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(body[i])
            i += 1
        return "".join(out).rstrip()
    if raw in ("T", "F"):
        return raw == "T"
    if _NUM_RE.match(raw):
        if re.search(r"[.EDed]", raw):
            return float(raw.replace("D", "E").replace("d", "e"))
        return int(raw)
    return raw


def _parse_cards(block_text):
    """Parse concatenated 80-char cards into a Header; detect END."""
    hdr = Header()
    ended = False
    for i in range(0, len(block_text), 80):
        card = block_text[i : i + 80]
        key = card[:8].strip()
        if key == "END":
            ended = True
            break
        if key in ("COMMENT", "HISTORY", ""):
            continue
        rest = card[8:]
        if key == "HIERARCH":
            body = card[9:]
            eq = body.find("= ")
            if eq < 0:
                eq = body.find("=")
                name = body[:eq].strip()
                rest = body[eq + 1 :]
            else:
                name = body[:eq].strip()
                rest = body[eq + 2 :]
            key = name
        elif rest[:2] == "= ":
            rest = rest[2:]
        else:
            continue  # commentary card
        # split off comment (a / outside quotes)
        in_str = False
        cut = len(rest)
        j = 0
        while j < len(rest):
            ch = rest[j]
            if ch == "'":
                in_str = not in_str
            elif ch == "/" and not in_str:
                cut = j
                break
            j += 1
        value = _parse_value(rest[:cut])
        comment = rest[cut + 1 :].strip() if cut < len(rest) else ""
        hdr.set(key, value, comment or None)
    return hdr, ended


def _pad(n):
    return (-n) % BLOCK


def _dtype_to_tform(dt, shape):
    count = int(np.prod(shape)) if shape else 1
    if dt.kind in ("S", "U"):
        width = dt.itemsize if dt.kind == "S" else dt.itemsize // 4
        return f"{width * count}A", width
    key = (dt.kind, dt.itemsize)
    if key not in _TFORM_OF:
        raise TypeError(f"unsupported column dtype: {dt}")
    return f"{count}{_TFORM_OF[key]}", None


def _tform_to_dtype(tform):
    m = re.fullmatch(r"(\d*)([LBIJKEDCMA])", tform.strip())
    if not m:
        raise TypeError(f"unsupported TFORM: {tform}")
    count = int(m.group(1) or 1)
    letter = m.group(2)
    if letter == "A":
        return np.dtype(f"S{count}"), 1
    kind, size = _DTYPE_OF[letter]
    base = {"b": "?", "u": "u", "i": "i", "f": "f", "c": "c"}[kind]
    dt = np.dtype(f">{base}{size}" if base != "?" else "?")
    if letter == "L":
        dt = np.dtype("?")
    return dt, count


class TableHDU:
    """A BINTABLE extension backed by a file offset (lazy reads)."""

    def __init__(self, fits, header, data_offset):
        self._fits = fits
        self.header = header
        self._offset = data_offset
        self._dtype, self._shapes = self._row_dtype()

    def _row_dtype(self):
        hdr = self.header
        fields = []
        shapes = {}
        for i in range(1, int(hdr.get("TFIELDS", 0)) + 1):
            name = str(hdr[f"TTYPE{i}"]).strip()
            dt, count = _tform_to_dtype(str(hdr[f"TFORM{i}"]))
            tdim = hdr.get(f"TDIM{i}")
            if tdim:
                dims = tuple(int(x) for x in str(tdim).strip("() ").split(","))
                shape = tuple(reversed(dims))
            elif count > 1 and dt.kind != "S":
                shape = (count,)
            else:
                shape = ()
            shapes[name] = shape
            fields.append((name, dt, shape) if shape else (name, dt))
        return np.dtype(fields), shapes

    # fitsio-compatible surface ------------------------------------------

    def get_extname(self):
        return str(self.header.get("EXTNAME", "")).strip()

    def get_nrows(self):
        return int(self.header.get("NAXIS2", 0))

    def read_header(self):
        return self.header

    def read(self, rows=None, columns=None):
        """Read the table (optionally a row range / subset of columns).

        ``rows``: None, slice, or (start, stop) tuple.
        Returns a structured array with native byte order.
        """
        nrows = self.get_nrows()
        if rows is None:
            start, stop = 0, nrows
        elif isinstance(rows, slice):
            start, stop, step = rows.indices(nrows)
            assert step == 1
        else:
            start, stop = rows
        raw = self._read_raw(start, stop)
        arr = np.frombuffer(raw, dtype=self._dtype)
        if columns is None:
            return arr.astype(arr.dtype.newbyteorder("="))
        # decode (byte-swap/copy) only the requested columns
        single = isinstance(columns, str)
        names = [columns] if single else list(columns)
        cols = self._decode_columns(raw, arr, names)
        fields = self._dtype.fields
        sub = np.empty(
            len(arr),
            dtype=[
                (n, fields[n][0].base.newbyteorder("="), self._shapes.get(n, ()))
                for n in names
            ],
        )
        for n in names:
            sub[n] = cols[n]
        return sub[columns] if single else sub

    def _read_raw(self, start, stop):
        """Row-range bytes, zero-copy when possible.

        Fast path: a read-only ``mmap`` view of the file (no syscall
        copy, no shared mutable buffer — safe for the concurrent
        prefetch-thread reads that corrupted a recycled buffer once).
        Fallback (mmap unavailable): a fresh per-call buffer via
        ``readinto``.  Short reads (truncated file, rows beyond EOF)
        raise instead of returning stale buffer contents.
        """
        rowsize = self._dtype.itemsize
        nbytes = max(0, stop - start) * rowsize
        offset = self._offset + start * rowsize
        view = self._fits._data_view(offset, nbytes)
        if view is not None:
            return view
        buf = bytearray(nbytes)
        view = memoryview(buf)
        with self._fits._reader() as f:
            f.seek(offset)
            got = f.readinto(view)
        if got != nbytes:
            raise OSError(
                f"short read: wanted rows [{start}, {stop}) "
                f"({nbytes} bytes), got {got} bytes"
            )
        return view

    def _decode_columns(self, raw, arr, names):
        """name -> contiguous native column array for the requested names.

        One strided ``astype`` pass per requested column: on the mmap
        fast path this touches only the requested columns' cache lines
        once (measured ~6x over a transposed full-buffer gather on this
        host), and the copy guarantees no view of the (possibly shared)
        raw buffer escapes.
        """
        fields = self._dtype.fields
        return {
            n: arr[n].astype(fields[n][0].base.newbyteorder("="))
            for n in names
        }

    def read_columns(self, names, rows=None):
        """Read columns as a dict of contiguous native 1-D/2-D arrays.

        The fast catalogue-paging path: skips the structured-array
        repacking of :meth:`read` entirely.
        """
        nrows = self.get_nrows()
        if rows is None:
            start, stop = 0, nrows
        else:
            start, stop = rows
        raw = self._read_raw(start, stop)
        arr = np.frombuffer(raw, dtype=self._dtype)
        return self._decode_columns(raw, arr, list(names))

    def __getitem__(self, key):
        """hdu[names][start:stop] access pattern used by catalogue paging."""
        if isinstance(key, (list, tuple)) or isinstance(key, str):
            return _ColumnSlicer(self, key)
        raise TypeError(key)


class _ColumnSlicer:
    def __init__(self, hdu, columns):
        self._hdu = hdu
        self._columns = columns

    def __getitem__(self, rows):
        if isinstance(rows, slice):
            return self._hdu.read(rows=rows, columns=self._columns)
        raise TypeError(rows)


class FitsFile:
    """A FITS file: sequence/mapping of HDUs (fitsio.FITS-like subset)."""

    def __init__(self, path, mode="r", clobber=False):
        self.path = os.fspath(path)
        self.mode = mode
        if mode not in ("r", "rw"):
            raise ValueError("mode must be 'r' or 'rw'")
        exists = os.path.exists(self.path)
        if mode == "rw" and (clobber or not exists):
            with open(self.path, "wb") as f:
                f.write(self._primary_bytes())
        elif not exists:
            raise FileNotFoundError(self.path)
        self._mm = None
        self._mm_lock = threading.Lock()
        self._scan()

    @staticmethod
    def _primary_bytes():
        cards = [
            _make_card("SIMPLE", True, "conforms to FITS standard"),
            _make_card("BITPIX", 8),
            _make_card("NAXIS", 0),
            _make_card("EXTEND", True),
            "END".ljust(80),
        ]
        text = "".join(cards)
        text += " " * _pad(len(text))
        return text.encode("ascii")

    def _reader(self):
        return open(self.path, "rb")

    def _data_view(self, offset, nbytes):
        """Read-only zero-copy view of file bytes, or None (fall back).

        The mmap is cached per file and remapped when a request reaches
        past its end (the file grew through an append — FITS appends
        never rewrite earlier bytes, so live views stay valid).  Reads
        off a mapping need no file-position lock, so concurrent
        prefetch-thread reads proceed without serialising.
        """
        mm = self._mm
        if mm is None or offset + nbytes > len(mm):
            with self._mm_lock:
                mm = self._mm
                if mm is None or offset + nbytes > len(mm):
                    try:
                        with self._reader() as f:
                            mm = mmap.mmap(
                                f.fileno(), 0, access=mmap.ACCESS_READ
                            )
                    except (OSError, ValueError):
                        return None
                    self._mm = mm
        if offset + nbytes > len(mm):
            raise OSError(
                f"short read: wanted {nbytes} bytes at {offset}, "
                f"file has {len(mm)}"
            )
        return memoryview(mm)[offset : offset + nbytes]

    def _scan(self):
        """Index all HDUs (header offsets, data offsets, sizes)."""
        self._hdus = []
        self._byname = {}
        size = os.path.getsize(self.path)
        with self._reader() as f:
            pos = 0
            first = True
            while pos < size:
                # read header blocks until END
                text = ""
                hpos = pos
                ended = False
                while not ended:
                    block = f.read(BLOCK)
                    if len(block) < BLOCK:
                        if first and not text:
                            raise OSError("not a FITS file")
                        return
                    pos += BLOCK
                    text += block.decode("ascii", errors="replace")
                    hdr, ended = _parse_cards(text)
                data_offset = pos
                if first:
                    datasize = 0
                    hdu = TableHDU(self, hdr, data_offset)
                    hdu._primary = True
                else:
                    naxis1 = int(hdr.get("NAXIS1", 0))
                    naxis2 = int(hdr.get("NAXIS2", 0))
                    datasize = naxis1 * naxis2 + int(hdr.get("PCOUNT", 0))
                    hdu = TableHDU(self, hdr, data_offset)
                self._hdus.append(hdu)
                name = hdu.get_extname()
                if name and name not in self._byname:
                    self._byname[name] = hdu
                skip = datasize + _pad(datasize)
                f.seek(skip, os.SEEK_CUR)
                pos += skip
                first = False

    # -- access -----------------------------------------------------------

    def __len__(self):
        return len(self._hdus)

    def __iter__(self):
        return iter(self._hdus)

    def __contains__(self, name):
        return name in self._byname

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            return self._hdus[key]
        try:
            return self._byname[key]
        except KeyError:
            raise OSError(f"extension {key!r} not found") from None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        # file handles are per-operation; only the mmap cache is held
        mm, self._mm = self._mm, None
        if mm is not None:
            try:
                mm.close()
            except BufferError:
                pass  # a live view still references the map; GC reclaims it

    # -- writing ------------------------------------------------------------

    def write_table(self, data, names=None, extname=None, header=None):
        """Append a BINTABLE extension.

        ``data``: structured array, or list of column arrays (with
        ``names``), or dict of name -> array.  ``header``: mapping or
        Header (or list of dicts with name/value/comment) of extra keys.
        """
        if self.mode != "rw":
            raise OSError("file not open for writing")
        if isinstance(data, dict):
            names = list(data.keys())
            cols = [np.asarray(v) for v in data.values()]
        elif isinstance(data, (list, tuple)):
            cols = [np.asarray(v) for v in data]
            if names is None:
                raise ValueError("names required with column list")
        elif data is None:
            cols, names = [], []
        else:  # structured array
            names = list(data.dtype.names)
            cols = [np.ascontiguousarray(data[n]) for n in names]

        nrows = len(cols[0]) if cols else 0
        fields = []
        tdims = []
        for name, col in zip(names, cols):
            shape = col.shape[1:]
            tform, _ = _dtype_to_tform(col.dtype, shape)
            dt = col.dtype
            if dt.kind not in ("S", "U"):
                dt = dt.newbyteorder(">")
            fields.append((name, dt, shape) if shape else (name, dt))
            tdims.append(shape if len(shape) > 1 else None)
        row_dtype = np.dtype(fields)

        rec = np.zeros(nrows, dtype=row_dtype)
        for name, col in zip(names, cols):
            rec[name] = col

        cards = [
            _make_card("XTENSION", "BINTABLE", "binary table extension"),
            _make_card("BITPIX", 8),
            _make_card("NAXIS", 2),
            _make_card("NAXIS1", row_dtype.itemsize),
            _make_card("NAXIS2", nrows),
            _make_card("PCOUNT", 0),
            _make_card("GCOUNT", 1),
            _make_card("TFIELDS", len(names)),
        ]
        for i, (name, col, tdim) in enumerate(zip(names, cols, tdims), start=1):
            tform, _ = _dtype_to_tform(col.dtype, col.shape[1:])
            cards.append(_make_card(f"TTYPE{i}", name))
            cards.append(_make_card(f"TFORM{i}", tform))
            if tdim:
                dims = ",".join(str(d) for d in reversed(tdim))
                cards.append(_make_card(f"TDIM{i}", f"({dims})"))
        if extname:
            cards.append(_make_card("EXTNAME", extname))
        if header:
            items = (
                [(d["name"], d["value"], d.get("comment", "")) for d in header]
                if isinstance(header, (list, tuple))
                else [(k, v, header.get_comment(k) if isinstance(header, Header) else "")
                      for k, v in (header.items())]
            )
            for k, v, c in items:
                if k.upper() in ("XTENSION", "BITPIX", "NAXIS", "NAXIS1",
                                 "NAXIS2", "PCOUNT", "GCOUNT", "TFIELDS",
                                 "EXTNAME"):
                    continue
                cards.append(_make_card(k, v, c))
        cards.append("END".ljust(80))
        text = "".join(cards)
        text += " " * _pad(len(text))

        payload = rec.tobytes()
        with open(self.path, "ab") as f:
            header_offset = f.tell()
            f.write(text.encode("ascii"))
            f.write(payload)
            f.write(b"\0" * _pad(len(payload)))
        # index the new extension incrementally (a full _scan() re-reads
        # every header and makes streaming appends O(n^2))
        hdr, _ = _parse_cards(text)
        hdu = TableHDU(self, hdr, header_offset + len(text))
        self._hdus.append(hdu)
        name = hdu.get_extname()
        if name and name not in self._byname:
            self._byname[name] = hdu

    # convenience used by the io layer
    def write(self, data, names=None, extname=None, header=None):
        self.write_table(data, names=names, extname=extname, header=header)
