"""The 95th percentile, in milliseconds, of all the window's decompress_array calls.

Each call is timed on the host's clock from its start to its return
(a decode's to the synchronise after it); the percentile is the
inclusive one of Python's ``statistics.quantiles(n=20)``.  None with
fewer than two calls.
"""

import statistics


def read(record: dict):
    calls = record["ops"]["decode"]
    if len(calls) < 2:
        return None
    return statistics.quantiles(calls, n=20, method="inclusive")[18] * 1e3
