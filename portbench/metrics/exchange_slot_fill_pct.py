"""The exchange: rows received over the send-slot rows shipped, in %,
over the window's jobs.  A hash or range exchange of P partitions ships
P x P slots of C rows in each attempt (the stage log's ``slot_rows``);
the rows received are the settled attempt's ``recv_rows``."""


def read(rec):
    got = shipped = 0
    for j in rec["jobs"]:
        for s in j["stages"]:
            got += sum(sum(r) for r in s["recv_rows"])
            p = max((len(r) for r in s["recv_rows"]), default=0)
            shipped += sum(c * p * p for att in s["slot_rows"] for c in att)
    return 100.0 * got / shipped if shipped else None
