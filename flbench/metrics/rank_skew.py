"""How unevenly the ranks of a mesh share a call's host work: the largest
rank's host time a call outside the exchange (the self time of its `fl.`
spans other than `fl.combine`, over its own traced window) over the mean of
all ranks'. 1 is an even split; a rank above it is the one the others wait
for in `fl.combine`. Nothing for a run of one rank."""


def read(record):
    per = [sum(ms for name, ms in s["self_ms"].items() if name != "combine") / s["calls"]
           for s in record.ranks if s.get("self_ms") and s["calls"]]
    if len(per) < 2 or len(per) != len(record.ranks):
        return None
    return max(per) / (sum(per) / len(per))
