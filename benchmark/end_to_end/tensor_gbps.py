"""Tensor bytes of all completed round trips over the window's seconds.

A round trip counts its tensor's bytes once; the window runs from its
start to the end of its last round trip.
"""


def read(record: dict):
    if not record.get("round_trips") or record["window_s"] <= 0:
        return None
    return record["round_trips"] * record["tensor_bytes"] / record["window_s"] / 1e9
