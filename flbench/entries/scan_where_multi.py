"""`analytics.scan_where_multi(path, preds, column)`: sum / min / max /
count of one column under ANDed predicates. A call covers every row of the
columns it names; its kernels must read the packed payload of those columns
in every chunk the predicates' zone maps do not rule out (on a mesh, of its
own rank's chunks: `part` = (rank, ranks))."""

from flbench import work


def columns(kwargs) -> list:
    return list(dict.fromkeys([kwargs["column"]] + [p[0] for p in kwargs["preds"]]))


def values(dataset, kwargs) -> int:
    return dataset.rows(kwargs["path"]) * len(columns(kwargs))


def work_of(dataset, kwargs, part=None) -> dict:
    return {"payload_bytes": work.table_payload_bytes(
        dataset, kwargs["path"], columns(kwargs), kwargs["preds"], part)}
