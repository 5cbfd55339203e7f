"""Seconds from the start of the run's process to its first timed call:
importing torch and the port, the CUDA context, loading (on a checkout's
first run, building) the port's libraries, making the data and warming
up the cell's own shapes."""


def read(record: dict):
    return record["setup_s"]
