"""`analytics.group_stats(path, key, value, preds=...)`: a GROUP BY with a
WHERE over one table. A call covers every row of the columns it names (key,
value, predicates); its kernels must read the packed payload of those
columns in every chunk the predicates' zone maps do not rule out (on a mesh,
of its own rank's chunks: `part` = (rank, ranks))."""

from flbench import work


def columns(kwargs) -> list:
    return list(dict.fromkeys([kwargs["key"], kwargs["value"]]
                              + [p[0] for p in kwargs.get("preds", ())]))


def values(dataset, kwargs) -> int:
    return dataset.rows(kwargs["path"]) * len(columns(kwargs))


def work_of(dataset, kwargs, part=None) -> dict:
    return {"payload_bytes": work.table_payload_bytes(
        dataset, kwargs["path"], columns(kwargs), kwargs.get("preds", ()), part)}
