"""TPC-H LINEITEM at scale factor 4, for four ranks of one SF1 share each:
the generator and writer of tpch-lineitem-sf1 (clause 4.2.3 of TPC-H
v3.0.1), run on this configuration's sizes."""

from flbench.dataset import load_module

_SF1 = load_module("configs", "tpch-lineitem-sf1")
VERSION = _SF1.VERSION
TABLE = _SF1.TABLE
generate = _SF1.generate
write = _SF1.write
#: the test size of SF1 with half its orders: each of a test's two ranks
#: takes a few chunks
SMALL = {**_SF1.SMALL, "orders": 3000}
