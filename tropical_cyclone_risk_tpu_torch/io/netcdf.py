"""Minimal self-contained NetCDF I/O (copy of
tropical_cyclone_risk_tpu/io/netcdf.py, reader and writer).

Neither xarray nor python-netCDF4 is needed:

- reading: NetCDF4 (HDF5-based) files via h5py, classic NetCDF3 by a
  streaming parser (scipy.io.netcdf_file as the fallback), auto-detected
  from the magic bytes;
- writing: classic NetCDF3 (64-bit offset) via scipy.io.netcdf_file,
  readable by xarray/netCDF4 downstream.  Used for every intermediate and
  output file (thermo_*.nc, env_wnd_*.nc, land/*.nc, tracks_*.nc).

Values are exposed as a plain :class:`Dataset` of numpy arrays with dims and
attrs.  Files written by either package read back identically in the other.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

_HDF5_MAGIC = b'\x89HDF'
_CDF_MAGIC = b'CDF'


@dataclasses.dataclass
class Variable:
    dims: Tuple[str, ...]
    data: np.ndarray
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Dataset:
    variables: Dict[str, Variable] = dataclasses.field(default_factory=dict)
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)

    def __getitem__(self, name: str) -> Variable:
        return self.variables[name]

    def __contains__(self, name: str) -> bool:
        return name in self.variables

    def keys(self):
        return self.variables.keys()


def _decode_attr(v):
    if isinstance(v, bytes):
        return v.decode('utf-8', 'replace')
    if isinstance(v, np.ndarray) and v.dtype.kind == 'S' and v.size == 1:
        return v[0].decode('utf-8', 'replace')
    return v


def _decode_cf_values(data: np.ndarray, fill, missing, sf, ao) -> np.ndarray:
    """CF decoding: mask fill/missing (in RAW packed units, before scaling),
    then apply scale_factor/add_offset.  Packed integer variables (ERA5 CDS
    int16 + scale/offset is the norm) become float64 with NaN at fill —
    matching xarray's behavior the reference relies on
    (thermo/calc_thermo.py:41 nan_to_num over land SSTs)."""
    mask = None
    for sentinel in (fill, missing):
        if sentinel is None:
            continue
        s = np.asarray(sentinel).ravel()[0]
        m = (data == np.asarray(s, dtype=data.dtype)
             if not np.issubdtype(data.dtype, np.floating)
             else (data == s))
        mask = m if mask is None else (mask | m)
    if sf is not None or ao is not None or (
            mask is not None and not np.issubdtype(data.dtype, np.floating)):
        data = data.astype(np.float64)
    if sf is not None:
        data = data * np.asarray(sf).ravel()[0]
    if ao is not None:
        data = data + np.asarray(ao).ravel()[0]
    if mask is not None and np.issubdtype(data.dtype, np.floating):
        data = np.where(mask, np.nan, data)
    return np.asarray(data)


def _decoded_dtype(raw_dt: np.dtype, fill, missing, sf, ao) -> np.dtype:
    """The dtype _decode_cf_values would produce for this raw dtype/attrs."""
    if sf is not None or ao is not None:
        return np.dtype(np.float64)
    if (fill is not None or missing is not None) \
            and not np.issubdtype(raw_dt, np.floating) \
            and raw_dt.kind != 'S':
        return np.dtype(np.float64)
    return raw_dt.newbyteorder('=')


_H5_CHUNK_ROWS_BYTES = 64 << 20


def _read_h5_var(obj, fill, missing, sf, ao) -> np.ndarray:
    """Read an h5py dataset CF-decoded, slab-by-slab for large variables so
    peak RSS is one DECODED copy plus a slab, not raw + decoded at once
    (packed-int16 ERA5 variables decode to float64 — 4x the raw bytes)."""
    raw_dt = obj.dtype
    if (raw_dt.kind not in 'iufS' or obj.ndim == 0
            or obj.size * raw_dt.itemsize < _H5_CHUNK_ROWS_BYTES):
        return _decode_cf_values(np.asarray(obj[()]), fill, missing, sf, ao)
    dst = np.zeros(obj.shape, _decoded_dtype(raw_dt, fill, missing, sf,
                                              ao))
    row_bytes = max(1, int(np.prod(obj.shape[1:])) * raw_dt.itemsize)
    step = max(1, _H5_CHUNK_ROWS_BYTES // row_bytes)
    for i in range(0, obj.shape[0], step):
        dst[i:i + step] = _decode_cf_values(
            np.asarray(obj[i:i + step]), fill, missing, sf, ao)
    return dst


def _read_h5(path: str, variables=None) -> Dataset:
    import h5py

    ds = Dataset()
    with h5py.File(path, 'r') as f:
        ds.attrs = {k: _decode_attr(v) for k, v in f.attrs.items()
                    if not k.startswith('_')}

        def visit(name, obj):
            if not isinstance(obj, h5py.Dataset):
                return
            if variables is not None \
                    and os.path.basename(name) not in variables:
                return
            # netCDF4 dimension scales double as coordinate variables.
            dims = []
            if 'DIMENSION_LIST' in obj.attrs:
                for i, refs in enumerate(obj.attrs['DIMENSION_LIST']):
                    try:
                        dims.append(os.path.basename(
                            f[refs[0]].name))
                    except Exception:
                        dims.append(f'dim_{i}')
            else:
                base = os.path.basename(name)
                dims = [base] if obj.ndim == 1 else [
                    f'{base}_d{i}' for i in range(obj.ndim)]
            attrs = {k: _decode_attr(v) for k, v in obj.attrs.items()
                     if k not in ('DIMENSION_LIST', 'REFERENCE_LIST', 'CLASS',
                                  'NAME', '_Netcdf4Dimid', '_Netcdf4Coordinates',
                                  '_FillValue')}
            fill = obj.attrs.get('_FillValue', None)
            data = _read_h5_var(
                obj,
                np.asarray(fill).ravel()[0] if fill is not None else None,
                attrs.pop('missing_value', None),
                attrs.pop('scale_factor', None),
                attrs.pop('add_offset', None))
            base = os.path.basename(name)
            if base in ds.variables and full_names.get(base) != name:
                # flattening groups by basename: a silent last-wins
                # collision would serve the wrong array downstream
                raise ValueError(
                    f'{path}: duplicate variable name {base!r} across HDF5 '
                    f'groups ({full_names[base]!r} vs {name!r}) — grouped '
                    f'NetCDF4 files are not supported')
            full_names[base] = name
            ds.variables[base] = Variable(tuple(dims), data, attrs)

        full_names: Dict[str, str] = {}
        f.visititems(visit)
    return ds


# classic NetCDF external types (CDF-1/2), big-endian on disk
_NC_DTYPES = {1: 'i1', 2: 'S1', 3: '>i2', 4: '>i4', 5: '>f4', 6: '>f8'}
_NC_DIMENSION, _NC_VARIABLE, _NC_ATTRIBUTE = 0x0A, 0x0B, 0x0C
_STREAM_CHUNK = 1 << 22


class _UnsupportedClassic(Exception):
    """Classic layout this parser does not speak — fall back to scipy."""


class _Cursor:
    """Sequential big-endian reader over the (buffered) header bytes."""

    def __init__(self, f, path):
        self.f, self.path = f, path

    def bytes(self, n: int) -> bytes:
        b = self.f.read(n)
        if len(b) != n:
            raise ValueError(f'{self.path}: truncated NetCDF header')
        return b

    def u32(self) -> int:
        return int.from_bytes(self.bytes(4), 'big')

    def i64(self) -> int:
        return int.from_bytes(self.bytes(8), 'big')

    def name(self) -> str:
        n = self.u32()
        s = self.bytes(n).decode('utf-8', 'replace')
        self.bytes((4 - n % 4) % 4)
        return s

    def attrs(self) -> Dict[str, object]:
        tag = self.u32()
        count = self.u32()
        if tag == 0 and count == 0:
            return {}
        if tag != _NC_ATTRIBUTE:
            raise ValueError(f'{self.path}: bad attribute-list tag {tag:#x}')
        out: Dict[str, object] = {}
        for _ in range(count):
            nm = self.name()
            typ = self.u32()
            n = self.u32()
            if typ not in _NC_DTYPES:
                raise ValueError(f'{self.path}: bad attribute type {typ}')
            dt = np.dtype(_NC_DTYPES[typ])
            raw = self.bytes(n * dt.itemsize)
            self.bytes((4 - (n * dt.itemsize) % 4) % 4)
            if typ == 2:
                out[nm] = raw
            else:
                vals = np.frombuffer(raw, dt).astype(dt.newbyteorder('='))
                out[nm] = vals
        return out


def _decode_into(dst_flat: np.ndarray, off: int, raw: np.ndarray,
                 fill, missing, sf, ao) -> None:
    """One chunk of the CF decode of _decode_cf_values, written into the
    preallocated output (mask on RAW units, then scale/offset, then NaN).

    The convert-first order and the in-place scale/offset are deliberate:
    comparing or multiplying a non-native-byteorder array drops numpy into
    ~140 MB/s buffered loops, while the native astype copy byteswaps at
    GB/s and everything after runs vectorized on it (the whole-file decode
    went 5.5 s -> ~1.5 s per 760 MB daily-wind pair).  Sentinel equality is
    byte-order independent (exact values; a NaN fill compares False either
    way, as before), and the raw-units mask is still taken BEFORE
    scale/offset."""
    out = raw.astype(dst_flat.dtype, copy=False)
    # the native-copy compare is only valid when the conversion is exact:
    # same-or-wider float, or an integer that fits the float's mantissa
    # (int32 data in an f32 destination could alias its sentinel)
    dk, rk = dst_flat.dtype.kind, raw.dtype.kind
    mant = {4: 24, 8: 53}.get(dst_flat.dtype.itemsize, 0) if dk == 'f' else 0
    exact = (dk == rk and dst_flat.dtype.itemsize >= raw.dtype.itemsize) \
        or (dk == 'f' and rk in 'iu'
            and 8 * raw.dtype.itemsize <= mant + (rk == 'i'))
    mask = None
    for sentinel in (fill, missing):
        if sentinel is None:
            continue
        s = np.asarray(sentinel).ravel()[0]
        if not np.issubdtype(raw.dtype, np.floating):
            s = np.asarray(s, dtype=raw.dtype)
        if exact:
            m = out == np.asarray(s, dtype=out.dtype)  # raw units, native
        else:
            m = (raw == s if np.issubdtype(raw.dtype, np.floating)
                 else raw == np.asarray(s, dtype=raw.dtype))
        mask = m if mask is None else (mask | m)
    inplace_ok = out is not raw and np.issubdtype(out.dtype, np.floating)
    if sf is not None:
        sf0 = np.asarray(sf).ravel()[0]
        out = np.multiply(out, sf0, out=out) if inplace_ok else out * sf0
        inplace_ok = inplace_ok or np.issubdtype(out.dtype, np.floating)
    if ao is not None:
        ao0 = np.asarray(ao).ravel()[0]
        out = np.add(out, ao0, out=out) if inplace_ok else out + ao0
    if mask is not None and np.issubdtype(dst_flat.dtype, np.floating):
        if inplace_ok:
            out[mask] = np.nan
        else:
            out = np.where(mask, np.nan, out)
    dst_flat[off:off + raw.size] = out


def _stream_extent(f, path: str, begin: int, dst_flat: np.ndarray,
                   elem_off: int, n_elems: int, raw_dt: np.dtype,
                   cf, buf: bytearray) -> None:
    """Stream one contiguous on-disk extent into dst_flat[elem_off:...],
    CF-decoding 4 MB at a time (never materializes the raw variable)."""
    f.seek(begin)
    nbytes = n_elems * raw_dt.itemsize
    mv = memoryview(buf)
    pos = 0
    while pos < nbytes:
        n = min(_STREAM_CHUNK, nbytes - pos)
        got = f.readinto(mv[:n])
        if got != n:
            raise ValueError(
                f'{path}: truncated NetCDF file (variable data ends at byte '
                f'{begin + pos + (got or 0)})')
        raw = np.frombuffer(mv[:n], raw_dt)
        _decode_into(dst_flat, elem_off, raw, *cf)
        elem_off += raw.size
        pos += n


def _read_classic_stream(path: str, variables=None) -> Dataset:
    """Parse a classic (CDF-1/CDF-2) NetCDF file by streaming each variable
    from disk straight into its final CF-decoded array.

    variables: optional name filter (see :func:`read`) — unselected
    variables are neither allocated nor read off disk.

    Replaces the earlier slurp-the-file-then-scipy approach: peak RSS is now
    the decoded arrays plus a 4 MB chunk buffer instead of decoded + one
    whole-file copy (with the winds prefetch thread keeping two u/v pairs
    resident, extra copies would cost several GB of RSS on real ERA5
    workspaces; the reference reads lazily via xarray/dask,
    util/input.py:16-21).  4 MB sequential readinto with
    POSIX_FADV_SEQUENTIAL avoids scipy's small buffered reads, which are
    slow on a cold page cache.
    """
    ds = Dataset()
    size = os.stat(path).st_size
    with open(path, 'rb') as f:
        try:
            os.posix_fadvise(f.fileno(), 0, 0, os.POSIX_FADV_SEQUENTIAL)
        except (AttributeError, OSError):
            pass
        cur = _Cursor(f, path)
        magic = cur.bytes(4)
        version = magic[3]
        if version not in (1, 2):
            raise _UnsupportedClassic(f'CDF version byte {version}')
        numrecs = cur.u32()
        streaming_recs = numrecs == 0xFFFFFFFF

        # dimensions
        tag, count = cur.u32(), cur.u32()
        dim_names, dim_sizes = [], []
        if tag == _NC_DIMENSION:
            for _ in range(count):
                dim_names.append(cur.name())
                dim_sizes.append(cur.u32())
        elif (tag, count) != (0, 0):
            raise ValueError(f'{path}: bad dimension-list tag {tag:#x}')
        rec_dim = dim_sizes.index(0) if 0 in dim_sizes else -1

        ds.attrs = {k: _decode_attr(v) for k, v in cur.attrs().items()}

        # variables
        tag, count = cur.u32(), cur.u32()
        if tag not in (_NC_VARIABLE, 0) or (tag == 0 and count != 0):
            raise ValueError(f'{path}: bad variable-list tag {tag:#x}')
        fixed, record = [], []
        for _ in range(count if tag == _NC_VARIABLE else 0):
            nm = cur.name()
            nd = cur.u32()
            dimids = [cur.u32() for _ in range(nd)]
            if any(d >= len(dim_names) for d in dimids):
                raise ValueError(f'{path}: variable {nm!r} references '
                                 f'missing dimension')
            attrs = {k: _decode_attr(v) for k, v in cur.attrs().items()}
            typ = cur.u32()
            cur.u32()                      # vsize (recomputed from shape)
            begin = cur.i64() if version == 2 else cur.u32()
            if typ not in _NC_DTYPES:
                raise ValueError(f'{path}: bad variable type {typ}')
            raw_dt = np.dtype(_NC_DTYPES[typ])
            is_rec = bool(dimids) and dimids[0] == rec_dim
            shape = tuple(dim_sizes[d] for d in dimids)
            (record if is_rec else fixed).append(
                (nm, dimids, attrs, raw_dt, begin, shape))

        # record geometry: per-record slab of each record variable is padded
        # to 4 bytes, except when there is exactly ONE record variable of a
        # 1/2-byte type (classic-format spec, "note on padding")
        slabs = []
        for nm, dimids, attrs, raw_dt, begin, shape in record:
            n = int(np.prod(shape[1:], dtype=np.int64)) if len(shape) > 1 \
                else 1
            b = n * raw_dt.itemsize
            slabs.append((n, b + (4 - b % 4) % 4))
        if len(record) == 1:
            n, _ = slabs[0]
            slabs = [(n, n * record[0][3].itemsize)]
        recsize = sum(b for _, b in slabs)
        if record:
            rec0 = min(v[4] for v in record)
            if streaming_recs:
                numrecs = max(0, (size - rec0) // recsize) if recsize else 0
            if rec0 + numrecs * recsize > size:
                raise ValueError(
                    f'{path}: truncated NetCDF file ({numrecs} records of '
                    f'{recsize} bytes past EOF)')

        # destination buffers use np.zeros, not np.empty: the streamed
        # decode writes each page exactly once, and calloc-backed zero
        # pages take huge-page faults where a first write into empty-mmap
        # pages faults page by page
        buf = bytearray(_STREAM_CHUNK)
        for nm, dimids, attrs, raw_dt, begin, shape in fixed:
            if variables is not None and nm not in variables:
                continue
            cf = (attrs.pop('_FillValue', None),
                  attrs.pop('missing_value', None),
                  attrs.pop('scale_factor', None),
                  attrs.pop('add_offset', None))
            dst = np.zeros(shape, _decoded_dtype(raw_dt, *cf))
            n_elems = int(np.prod(shape, dtype=np.int64))
            if begin + n_elems * raw_dt.itemsize > size:
                raise ValueError(
                    f'{path}: truncated NetCDF file (variable {nm!r} data '
                    f'extends past EOF)')
            _stream_extent(f, path, begin, dst.reshape(-1), 0, n_elems,
                           raw_dt, cf, buf)
            ds.variables[nm] = Variable(
                tuple(dim_names[d] for d in dimids), dst, attrs)

        rec_vars = []
        for i, (nm, dimids, attrs, raw_dt, begin, shape) in enumerate(record):
            if variables is not None and nm not in variables:
                rec_vars.append(None)
                continue
            cf = (attrs.pop('_FillValue', None),
                  attrs.pop('missing_value', None),
                  attrs.pop('scale_factor', None),
                  attrs.pop('add_offset', None))
            shape = (numrecs,) + shape[1:]
            dst = np.zeros(shape, _decoded_dtype(raw_dt, *cf))
            rec_vars.append((dst, slabs[i][0], cf))
            ds.variables[nm] = Variable(
                tuple(dim_names[d] for d in dimids), dst, attrs)
        for r in range(numrecs):
            for i, (nm, dimids, attrs, raw_dt, begin, shape) in \
                    enumerate(record):
                if rec_vars[i] is None:
                    continue
                dst, n, cf = rec_vars[i]
                _stream_extent(f, path, begin + r * recsize,
                               dst.reshape(-1), r * n, n, raw_dt, cf, buf)
    return ds


def _read_classic(path: str, variables=None) -> Dataset:
    try:
        return _read_classic_stream(path, variables)
    except _UnsupportedClassic:
        ds = _read_classic_scipy(path)
        if variables is not None:
            ds.variables = {k: v for k, v in ds.variables.items()
                            if k in variables}
        return ds


def _read_classic_scipy(path: str) -> Dataset:
    import io as _io

    from scipy.io import netcdf_file

    ds = Dataset()
    # Fallback for classic layouts _read_classic_stream does not parse:
    # slurp the file sequentially and parse from memory (scipy's buffered
    # per-variable reads are slow on a cold page cache).  Peak RSS is one
    # file copy + parsed data — bounded-memory reads live in
    # _read_classic_stream.
    with open(path, 'rb') as fraw:
        try:
            os.posix_fadvise(fraw.fileno(), 0, 0, os.POSIX_FADV_SEQUENTIAL)
        except (AttributeError, OSError):
            pass
        size = os.fstat(fraw.fileno()).st_size
        data = bytearray(size)
        view = memoryview(data)
        pos = 0
        while pos < size:
            got = fraw.readinto(view[pos:pos + (1 << 22)])
            if not got:
                break
            pos += got
        tail = fraw.read()          # in case the file grew after fstat
        if tail:
            data += tail
        elif pos < size:
            del view
            data = data[:pos]       # file shrank: parse what was read
    view = None

    class _MemReader(_io.RawIOBase):
        """Read-only seekable view over the bytearray — BytesIO(data)
        would copy the whole buffer, transiently doubling RSS again."""

        def __init__(self, mv):
            self._mv = memoryview(mv)
            self._pos = 0

        def readable(self):
            return True

        def seekable(self):
            return True

        def seek(self, off, whence=0):
            base = (0, self._pos, len(self._mv))[whence]
            self._pos = max(0, base + off)
            return self._pos

        def tell(self):
            return self._pos

        def readinto(self, b):
            n = min(len(b), len(self._mv) - self._pos)
            if n <= 0:
                return 0
            b[:n] = self._mv[self._pos:self._pos + n]
            self._pos += n
            return n

    buf = _MemReader(data)
    with netcdf_file(buf, 'r', mmap=False) as f:
        ds.attrs = {k: _decode_attr(v) for k, v in f._attributes.items()}
        for name, var in f.variables.items():
            attrs = {k: _decode_attr(v) for k, v in var._attributes.items()}
            # mmap=False: scipy already materialized the data; no copy
            data = np.asarray(var[()])
            data = _decode_cf_values(data, attrs.pop('_FillValue', None),
                                     attrs.pop('missing_value', None),
                                     attrs.pop('scale_factor', None),
                                     attrs.pop('add_offset', None))
            ds.variables[name] = Variable(tuple(var.dimensions), data, attrs)
    return ds


def read(path: str, variables=None) -> Dataset:
    """Read a NetCDF file (classic or HDF5-based) into a :class:`Dataset`.

    variables: optional collection of variable names — only those variables
    are decoded and returned (global attrs and the vars' own attrs/dims are
    kept).  A classic-format read skips the unselected variables' disk
    extents entirely, so e.g. reading just the time axis of a GB-scale
    daily-wind file costs one header parse plus a few KB
    (preprocess.winds uses this to skip file pairs outside the configured
    date range before paying for a full read).

    Corrupt/truncated files raise ValueError naming the file — the raw
    scipy/h5py parse errors (struct unpack sizes, HDF5 signature checks)
    do not say WHICH file of a multifile set is broken."""
    with open(path, 'rb') as f:
        magic = f.read(4)
    try:
        if magic.startswith(_HDF5_MAGIC):
            return _read_h5(path, variables)
        if magic.startswith(_CDF_MAGIC):
            return _read_classic(path, variables)
    except ValueError as e:
        if path in str(e):
            raise                  # already-contextualized error
        raise ValueError(
            f'{path}: corrupted or truncated NetCDF file '
            f'(ValueError: {e}); re-download or regenerate it') from e
    except Exception as e:
        raise ValueError(
            f'{path}: corrupted or truncated NetCDF file '
            f'({type(e).__name__}: {e}); re-download or regenerate it'
        ) from e
    raise ValueError(f'{path}: not a NetCDF file (magic={magic!r})')


def _preflight_limit(sizes: Dict[str, int]) -> list:
    """Classic NetCDF (64-bit offset) caps every fixed variable except the
    LAST defined one at 4 GiB - 4 of data.  Returns the write order
    (an oversized variable moved last); raises with the mitigation when
    more than one variable is oversized — before any bytes are staged,
    instead of a corrupt or truncated file at the end of a 700k-track
    member write."""
    limit = (1 << 32) - 4
    big = [n for n, sz in sizes.items() if sz > limit]
    if len(big) > 1:
        mb = {n: sizes[n] >> 20 for n in big}
        raise ValueError(
            f'classic NetCDF cannot hold {len(big)} variables over 4 GiB '
            f'(only the last-defined may exceed it): {mb} MiB. Mitigation: '
            f'split the run into more ensemble members '
            f'(runtime.run_downscaling per member) or reduce '
            f'tracks_per_year x years per file.')
    return [n for n in sizes if n not in big] + big


def write(path: str,
          data_vars: Dict[str, Tuple[Sequence[str], np.ndarray]],
          coords: Optional[Dict[str, np.ndarray]] = None,
          attrs: Optional[Dict[str, object]] = None,
          var_attrs: Optional[Dict[str, Dict[str, object]]] = None) -> None:
    """Write a classic NetCDF3 (64-bit offset) file.

    data_vars: name -> (dims, array).  Unicode string arrays ('U' kind) are
    stored as char matrices with an extra string-length dimension, matching
    how xarray serializes them (e.g. tc_basins in the reference's track files,
    util/compute.py:260).
    coords: 1-D coordinate variables keyed by their dimension name.
    """
    from scipy.io import netcdf_file

    coords = coords or {}
    attrs = attrs or {}
    var_attrs = var_attrs or {}

    dim_sizes: Dict[str, int] = {}

    def coerce(arr: np.ndarray) -> np.ndarray:
        # classic NetCDF3 has no 64-bit ints / 16-bit floats
        if arr.dtype == np.int64 or arr.dtype == np.uint32 or arr.dtype == np.uint64:
            if arr.size and (arr.min() < -2**31 or arr.max() >= 2**31):
                # int32 would silently wrap (e.g. an epoch-seconds time
                # axis); float64 is exact to 2**53
                return arr.astype(np.float64)
            return arr.astype(np.int32)
        if arr.dtype == np.float16:
            return arr.astype(np.float32)
        if arr.dtype == np.bool_:
            return arr.astype(np.int8)
        return arr

    def note_dims(dims, shape):
        for d, s in zip(dims, shape):
            if d in dim_sizes and dim_sizes[d] != int(s):
                raise ValueError(f'dimension {d} has conflicting sizes '
                                 f'{dim_sizes[d]} vs {s}')
            dim_sizes[d] = int(s)

    prepared: Dict[str, Tuple[Tuple[str, ...], np.ndarray]] = {}
    for name, (dims, arr) in data_vars.items():
        arr = coerce(np.asarray(arr))
        dims = tuple(dims)
        if arr.dtype.kind == 'U':
            slen = max(1, int(arr.dtype.itemsize // 4))
            sdim = f'string{slen}'
            chars = arr.astype(f'S{slen}')[..., None].view('S1').reshape(
                arr.shape + (slen,))
            arr = chars
            dims = dims + (sdim,)
            # xarray decodes char matrices back to unicode strings only
            # when _Encoding is present; without it the reference notebook's
            # `tc_basins == 'NA'` comparisons would see bytes
            va = dict(var_attrs.get(name, {}))
            va.setdefault('_Encoding', 'utf-8')
            var_attrs = {**var_attrs, name: va}
        if len(dims) != arr.ndim:
            raise ValueError(f'{name}: dims {dims} do not match shape {arr.shape}')
        note_dims(dims, arr.shape)
        prepared[name] = (dims, arr)
    coords = {name: coerce(np.asarray(arr)) for name, arr in coords.items()}
    for name, arr in coords.items():
        note_dims((name,), arr.shape)

    # per-writer tmp name: two processes writing the same destination
    # (racing ensemble members, double-launched idempotent preprocessing)
    # must not interleave into one staging file
    tmp = f'{path}.tmp.{os.getpid()}'
    with netcdf_file(tmp, 'w', version=2) as f:
        for k, v in attrs.items():
            setattr(f, k, v)
        for d, s in dim_sizes.items():
            f.createDimension(d, s)
        for name, arr in coords.items():
            v = f.createVariable(name, arr.dtype, (name,))
            v[:] = arr
            for k, val in var_attrs.get(name, {}).items():
                setattr(v, k, val)
        sizes = {name: ((arr.size * arr.dtype.itemsize + 3) // 4) * 4
                 for name, (dims, arr) in prepared.items()
                 if name not in coords}
        for name in _preflight_limit(sizes):
            dims, arr = prepared[name]
            v = f.createVariable(name, arr.dtype, dims)
            v[:] = arr
            for k, val in var_attrs.get(name, {}).items():
                setattr(v, k, val)
    os.replace(tmp, path)   # atomic publish: no torn files on concurrent runs
