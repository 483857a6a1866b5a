"""Arrow / Parquet / pandas / CSV interop for FLT tables.

The port of fastlanes_tpu/interop.py over the port's own `fio_table`: the
table files it writes are byte-identical to the JAX package's.

Everything routes through Apache Arrow: an Arrow table's columns map to
this framework's column model (nullable via validity masks, strings via
sorted dictionaries, bools on u8, temporal types on their int64 storage)
and back without loss. pyarrow/pandas are OPTIONAL — import errors
surface only when these entry points are used; the core library has no
dependency on them.

    from fastlanes_tpu_torch import interop
    interop.parquet_to_flt("events.parquet", "events.flt")
    df = interop.read_table_to_pandas("events.flt")
    interop.flt_to_parquet("events.flt", "roundtrip.parquet")
"""

from __future__ import annotations

import numpy as np

from . import fio_table


def _pa():
    try:
        import pyarrow as pa
        return pa
    except ImportError as e:  # pragma: no cover - env without pyarrow
        raise ImportError(
            "pyarrow is required for Arrow/Parquet interop; the core "
            "library works without it") from e


def arrow_to_columns(table) -> dict:
    """Arrow table -> {name: numpy array} in this framework's column model
    (np.ma masked where the Arrow column has nulls; strings as object
    arrays holding None; dictionary-encoded columns decoded)."""
    out = {}
    for name in table.column_names:
        try:
            out[name] = _arrow_array_to_numpy(table.column(name))
        except UnicodeDecodeError as e:
            raise ValueError(
                f"column {name!r}: binary values are not valid UTF-8; FLT "
                "string columns store UTF-8 text") from e
    return out


def _arrow_array_to_numpy(arr):
    pa = _pa()
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    t = arr.type
    if pa.types.is_dictionary(t):
        return _arrow_array_to_numpy(arr.cast(t.value_type))
    mask = np.asarray(arr.is_null())
    if (pa.types.is_string(t) or pa.types.is_large_string(t)
            or pa.types.is_binary(t) or pa.types.is_large_binary(t)):
        out = np.empty(len(arr), object)
        out[:] = arr.to_pylist()  # None stays None (= null)
        if pa.types.is_binary(t) or pa.types.is_large_binary(t):
            out[:] = [v.decode("utf-8") if isinstance(v, bytes) else v
                      for v in out]
        return out
    if mask.any():
        fill = pa.scalar(False, t) if pa.types.is_boolean(t) else \
            pa.scalar(0, t)
        vals = arr.fill_null(fill).to_numpy(zero_copy_only=False)
        return np.ma.MaskedArray(vals, mask=mask)
    return arr.to_numpy(zero_copy_only=False)


def columns_to_arrow(columns: dict):
    """{name: numpy array} (as produced by fio_table.read_table) -> Arrow
    table; masks become Arrow validity, object/unicode arrays become
    strings."""
    pa = _pa()
    arrays = {}
    for name, v in columns.items():
        if isinstance(v, np.ma.MaskedArray):
            data = np.asarray(np.ma.getdata(v))
            mask = np.ma.getmaskarray(v)
            if data.dtype.kind in ("U", "O"):
                arrays[name] = pa.array(
                    [None if m else str(x) for x, m in zip(data, mask)],
                    type=pa.string())
            else:
                arrays[name] = pa.array(data, mask=mask)
        elif v.dtype == object or v.dtype.kind == "U":
            arrays[name] = pa.array(
                [None if x is None else str(x) for x in v.tolist()],
                type=pa.string())
        else:
            arrays[name] = pa.array(np.asarray(v))
    return pa.table(arrays)


def parquet_to_flt(parquet_path: str, flt_path: str, codec: str = "auto",
                   chunk_blocks: int = 1024,
                   batch_rows: int = 0) -> dict:
    """Compress a Parquet file into an FLT table (all column types the
    wire format supports: ints, floats, strings, bools, temporal, nulls).
    Returns the FLT header.

    `batch_rows` > 0 streams: Parquet record batches feed a TableWriter,
    so neither format's columns ever materialize whole — constant memory
    for arbitrarily large files (and byte-identical output)."""
    import pyarrow.parquet as pq

    if batch_rows > 0:
        pf = pq.ParquetFile(parquet_path)
        with fio_table.TableWriter(flt_path, codec=codec,
                                   chunk_blocks=chunk_blocks) as w:
            for batch in pf.iter_batches(batch_size=batch_rows):
                w.append({name: _arrow_array_to_numpy(batch.column(i))
                          for i, name in enumerate(batch.schema.names)})
        return w.header
    cols = arrow_to_columns(pq.read_table(parquet_path))
    return fio_table.write_table(flt_path, cols, codec=codec,
                                 chunk_blocks=chunk_blocks)


def flt_to_parquet(flt_path: str, parquet_path: str) -> None:
    """Decompress an FLT table into a Parquet file (nulls, strings and
    logical types preserved)."""
    import pyarrow.parquet as pq

    pq.write_table(columns_to_arrow(fio_table.read_table(flt_path)),
                   parquet_path)


def csv_to_flt(csv_path: str, flt_path: str, codec: str = "auto",
               chunk_blocks: int = 1024) -> dict:
    """Compress a CSV file into an FLT table (type inference and null
    detection via Arrow's CSV reader)."""
    from pyarrow import csv as pa_csv

    cols = arrow_to_columns(pa_csv.read_csv(csv_path))
    return fio_table.write_table(flt_path, cols, codec=codec,
                                 chunk_blocks=chunk_blocks)


def write_table_from_pandas(flt_path: str, df, codec: str = "auto",
                            chunk_blocks: int = 1024) -> dict:
    """Compress a pandas DataFrame into an FLT table (via Arrow, so
    pandas nullable dtypes and datetimes map losslessly)."""
    pa = _pa()
    cols = arrow_to_columns(pa.Table.from_pandas(df, preserve_index=False))
    return fio_table.write_table(flt_path, cols, codec=codec,
                                 chunk_blocks=chunk_blocks)


def read_table_to_pandas(flt_path: str):
    """Decompress an FLT table into a pandas DataFrame (nullable columns
    come back as Arrow-backed nullable dtypes)."""
    return columns_to_arrow(fio_table.read_table(flt_path)).to_pandas()
